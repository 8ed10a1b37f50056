#!/usr/bin/env python3
"""Run chip_smoke's phase (u) alone on the card: the build, then each of
its parts in turn, every gate as chip_smoke holds it.

    python3 tools/rank_probe.py [u1] [u2] [u3] [u4]

(u1) data-parallel TinyLlama-1.1B on two `gloo` ranks with its gradient
witness, (u2) the expert-parallel qwen2-moe-a2.7b prefill on two ranks
with its rounding witness, (u3) the elastic drill across 8 ranks, (u4)
one `nccl` rank; all of them when none is named. Prints chip_smoke's
JSON lines and, last, `PROBE OK` or `PROBE FAILED`; exits 1 if any part
failed.
"""
import os
import sys
import time
import traceback


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import chip_smoke as cs
    card = cs.phase_device(torch)
    t0 = time.perf_counter()
    cs.phase_build()
    cs.emit("phase_time", name="a_build", seconds=time.perf_counter() - t0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    parts = {"u1": cs.phase_dp_train, "u2": cs.phase_ep_prefill,
             "u3": cs.phase_rank_drill, "u4": cs.phase_nccl_rank}
    names = sys.argv[1:] or list(parts)
    ok = True
    for name in names:
        t0 = time.perf_counter()
        try:
            out = parts[name](torch, dev, card)
            cs.emit("probe_launches", name=name,
                    launches={k: v for k, v in (out or {}).items() if v})
        except Exception:
            ok = False
            traceback.print_exc(file=sys.stdout)
            print("PROBE FAIL", name, flush=True)
        cs.emit("phase_time", name=name, seconds=time.perf_counter() - t0)
        cs.free_card(torch)
    print("PROBE OK" if ok else "PROBE FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
