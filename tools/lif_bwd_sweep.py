#!/usr/bin/env python3
"""Sweep the LIF surrogate backward's layouts (csrc/lif.cu: the 16-byte
stream, the slab ring filled by TMA and the same ring filled by
cp.async) on the card, to set and check the switch that picks one.

    python3 tools/lif_bwd_sweep.py [--max-elems=N] [--steps=T,...]
                                   [--neurons=P,...]

For T in {1, 2, 4, 16, 64, 256, 2048} and P in {5632, 22528, 90112,
360448, 1441792, 3145728} (T*P at most 2^28 elements by default), f32
and bf16 cotangents: each layout through `lif_scan.lif_bwd_forced`, its
dx equal to the stream's bit for bit, the device ms of each (the kernel
alone, `chip_smoke.graph_ms`) timed in turns (a, b, c, c, b, a), the
layout the switch picks (`lif_scan.bwd_launch`), the byte bound (vres
read, g read, dx written once, over 3.35 TB/s). Prints the card's name
and power limit, one JSON line a case and a last summary line: the
cases where the switch's pick is more than 5% slower than the fastest
layout. `--steps` and `--neurons` replace the two lists. Exits nonzero
on a mismatch.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts the repo's src on the path)

STEPS = (1, 2, 4, 16, 64, 256, 2048)
NEURONS = (5632, 4 * 5632, 16 * 5632, 64 * 5632, 256 * 5632, 32 * 1024 * 96)
MAX_ELEMS = 1 << 28
SLOWER = 1.05          # a pick this much over the fastest is reported
KW = dict(decay=0.5, v_th=1.0, soft_reset=True)


def sweep_case(torch, lif_scan, t, p, dtype, gen):
    vres = torch.randn((t, p), generator=gen, device="cuda") * 0.8 + 0.6
    g = torch.randn((t, p), generator=gen, device="cuda").to(dtype)
    layouts = lif_scan.BWD_LAYOUTS
    calls = {name: (lambda name=name: lif_scan.lif_bwd_forced(
        vres, g, name, **KW)) for name in layouts}
    outs = {name: fn() for name, fn in calls.items()}
    same = all(torch.equal(outs["stream"], o) for o in outs.values())
    del outs
    reps = 20 if t * p <= 1 << 24 else 5
    times = {name: [] for name in layouts}
    for name in (*layouts, *reversed(layouts)):
        times[name].append(cs.graph_ms(torch, calls[name], reps=reps))
    ms = {name: sum(v) / len(v) for name, v in times.items()}
    bf16 = dtype == torch.bfloat16
    pick = lif_scan.bwd_launch(t, p, bf16)
    best = min(ms, key=ms.get)
    n_bytes = t * p * (4 + 2 * g.element_size())
    rec = {"dtype": "bf16" if bf16 else "f32", "t": t, "p": p,
           "ms": ms, "fastest": best, "pick": pick["layout"],
           "pick_over_fastest": ms[pick["layout"]] / ms[best],
           "bound_ms": n_bytes / cs.HBM_BYTES_PER_S * 1e3,
           "launch": pick, "equal": same}
    torch.cuda.empty_cache()
    return rec


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("lif_bwd_sweep: no CUDA device", file=sys.stderr)
        return 2
    max_elems, steps, neurons = MAX_ELEMS, STEPS, NEURONS
    for arg in argv:
        name, _, value = arg.partition("=")
        if name == "--max-elems":
            max_elems = int(value)
        elif name == "--steps":
            steps = tuple(int(v) for v in value.split(","))
        elif name == "--neurons":
            neurons = tuple(int(v) for v in value.split(","))
        else:
            raise SystemExit(f"lif_bwd_sweep: unknown argument {arg}")
    from repro_torch.kernels import lif_scan
    cs.phase_device(torch)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    ok, slow = True, []
    for dtype in (torch.float32, torch.bfloat16):
        for t in steps:
            for p in neurons:
                if t * p > max_elems:
                    continue
                rec = sweep_case(torch, lif_scan, t, p, dtype, gen)
                print(json.dumps(rec), flush=True)
                ok &= rec["equal"]
                if rec["pick_over_fastest"] > SLOWER:
                    slow.append([rec["dtype"], t, p, rec["pick"],
                                 rec["fastest"], rec["pick_over_fastest"]])
    print(json.dumps({"summary": "switch", "slow_picks": slow,
                      "all_equal": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
