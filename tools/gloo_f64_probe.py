#!/usr/bin/env python3
"""All-reduce f32 and f64 card tensors of 1 to 2^20 elements over `gloo`
ranks sharing one card: over two ranks (pairs) and over all four, in
one world of four ranks on `cuda:0`, each case printed by each rank as
it completes. A rank that dies mid-case leaves the others to the spawn's
deadline, which prints their stacks.

    PYTHONFAULTHANDLER=1 python3 tools/gloo_f64_probe.py

Prints `CASES OK` and rank 0's results, or `CASES FAILED` and the
traceback. It needs a card.
"""
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def rank_fn(cases):
    import torch
    import torch.distributed as dist
    from repro_torch.launch import distributed
    dev = distributed.device()
    me = distributed.rank()
    groups = {"world": None, "pair": dist.new_group([0, 1]),
              "pair2": dist.new_group([2, 3])}
    out = []
    for gname, dtype, n in cases:
        if gname == "pair" and me > 1 or gname == "pair2" and me < 2:
            continue
        t = torch.full((n,), 1.0 + me / 8, dtype=dtype, device=dev)
        try:
            dist.all_reduce(t, group=groups[gname])
            torch.cuda.synchronize()
            out.append((gname, str(dtype), n, "ok", float(t[0])))
        except Exception as e:     # noqa: BLE001 (recorded and printed)
            out.append((gname, str(dtype), n, "error", repr(e)[:200]))
        print(me, out[-1], flush=True)
    return out


def main() -> int:
    import torch
    from repro_torch.launch import distributed
    cases = [(g, dt, n) for g in ("pair", "world")
             for dt in (torch.float32, torch.float64)
             for n in (1, 33, 4096, 1 << 20)]
    try:
        res = distributed.spawn(rank_fn, 4, backend="gloo",
                                device="cuda:0", timeout_s=90,
                                args=(cases,))
    except (RuntimeError, TimeoutError):
        print("CASES FAILED", flush=True)
        traceback.print_exc(file=sys.stdout)
        return 1
    print("CASES OK", res[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
