#!/usr/bin/env python3
"""Build and run tools/apec_tc_probe.cu on the card: clocks a slice of the
pipelined APEC kernels' loop alone, with its MMAs alone, and with its
copies by cp.async or by cp.async.bulk (see the source's header).

    python3 tools/apec_tc_probe.py       # from the root of a checkout

Prints the card's name and power limit, then one JSON line per mode.
The binary lands in build/ (ignored by git)."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    out = ROOT / "build" / "apec_tc_probe"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", str(out),
                    str(ROOT / "tools" / "apec_tc_probe.cu")], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0],
          flush=True)
    return subprocess.run([str(out)], timeout=300).returncode


if __name__ == "__main__":
    sys.exit(main())
