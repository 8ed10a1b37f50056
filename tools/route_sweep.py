#!/usr/bin/env python3
"""Time hybrid dispatch's two routes on the card: the sweep the cost
model's route predicate is fit on.

    python3 tools/route_sweep.py [--out tools/route_sweep_h100.json]

For `spike_matmul` and `apec_matmul` (g = 2), on the calibration tile grid
of `core.costmodel` (CALIBRATION_TILES_M x CALIBRATION_TILES_K tiles of
128 x 128: SpikingFormer-4-384's FFN fc2 at T=4, B=32, (8192 x 1536) x
(1536 x 384)), at one occupied-tile count per pow2 bucket of the grid
(`costmodel.bucket_representative`): binary spikes whose live tiles are
exactly that many tiles placed uniformly at random, half dense inside a
live tile, with their exact map carried; the dense route `cuda-pred` and
the event route `cuda` through `dispatch.call_backend`, each as the
device time of one call from a CUDA graph of 20 (chip_smoke's
`graph_ms`), timed in turns (dense, event, event, dense). The two routes
must give the same output bits. Two sweeps per op (seeds 0 and 1).

Writes the points, (occupied, t_dense_us, t_event_us) in descending
occupied order per sweep, with the card's `nvidia-smi` name and power
limit, to --out (`costmodel.crossover_points_from_sweep` reads it back;
`costmodel.ROUTE_CALIBRATION_POINTS` is its transcription), and prints
each point, then each op's fit (r, h) and the points the fitted
predicate routes to the slower route. Needs a card; exits nonzero
without one or on a mismatch.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts the repo's src on the path)

OPS = (("spike_matmul", {}), ("apec_matmul", {"g": 2}))
SEEDS = (0, 1)
TILE = 128


def live_tile_spikes(torch, mt, kt, n_live, seed, device):
    """(mt*128, kt*128) f32 spikes with exactly `n_live` live tiles at
    uniformly random places, each element of a live tile 1 with
    probability 0.5."""
    gen = torch.Generator().manual_seed(seed)
    live = torch.zeros(mt * kt, dtype=torch.bool)
    live[torch.randperm(mt * kt, generator=gen)[:n_live]] = True
    mask = live.reshape(mt, kt).repeat_interleave(TILE, 0) \
        .repeat_interleave(TILE, 1)
    bits = torch.rand((mt * TILE, kt * TILE), generator=gen) < 0.5
    return (mask & bits).float().to(device)


def sweep(torch, op, kw, seed, device):
    from repro_torch.core import costmodel
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.ops import padded_occupancy
    mt, kt = costmodel.CALIBRATION_TILES_M, costmodel.CALIBRATION_TILES_K
    total = mt * kt
    gen = torch.Generator().manual_seed(1000 + seed)
    w = torch.randn((kt * TILE, costmodel.CALIBRATION_N),
                    generator=gen).to(device)
    counts = sorted({costmodel.bucket_representative(b, total)
                     for b in range(costmodel.num_buckets(total))},
                    reverse=True)
    points = []
    for n_live in counts:
        s = live_tile_spikes(torch, mt, kt, n_live, seed * 7919 + n_live,
                             device)
        occ = padded_occupancy(s)
        cs.check(int((occ > 0).sum()) == n_live,
                 f"{op}: {n_live} live tiles wanted")

        def route(name):
            return lambda: dispatch.call_backend(op, name, s, w,
                                                 occupancy=occ, **kw)
        dense, event = route(dispatch.CUDA_PRED), route(dispatch.CUDA)
        with torch.inference_mode():
            same = torch.equal(dense(), event())
            d1, e1 = cs.graph_ms(torch, dense), cs.graph_ms(torch, event)
            e2, d2 = cs.graph_ms(torch, event), cs.graph_ms(torch, dense)
        cs.check(same, f"{op}: the routes differ at {n_live} live tiles")
        t_dense = round((d1 + d2) / 2 * 1e3, 3)
        t_event = round((e1 + e2) / 2 * 1e3, 3)
        cs.emit("route_point", op=op, seed=seed, occupied=n_live,
                bucket=costmodel.pow2_bucket(n_live), t_dense_us=t_dense,
                t_event_us=t_event, equal_bits=same)
        points.append([n_live, t_dense, t_event])
    return {"op": op, "seed": seed, **kw, "points": points}


def fit_report(path: str) -> None:
    """Per op: the fit (r, h), and the measured points whose faster route
    the fitted predicate does not pick."""
    from repro_torch.core import costmodel
    mt, kt = costmodel.CALIBRATION_TILES_M, costmodel.CALIBRATION_TILES_K
    for op, _ in OPS:
        points = costmodel.crossover_points_from_sweep(path, op)
        r, h = costmodel.fit_route_params(points, mt, kt)
        wrong = []
        for occupied, t_dense, t_event in points:
            dense, event = costmodel.route_step_costs(occupied, mt, kt, r, h)
            if (event < dense) != (t_event < t_dense):
                wrong.append([occupied, t_dense, t_event])
        cs.emit("route_fit", op=op, r=r, h=h, mispredicted=wrong)


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / "tools" /
                                             "route_sweep_h100.json"))
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("route_sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = cs.phase_device(torch)
    from repro_torch.core import costmodel
    sweeps = [sweep(torch, op, kw, seed, device)
              for op, kw in OPS for seed in SEEDS]
    payload = {"card": card, "torch": torch.__version__,
               "cuda": torch.version.cuda,
               "tiles": [costmodel.CALIBRATION_TILES_M,
                         costmodel.CALIBRATION_TILES_K],
               "n": costmodel.CALIBRATION_N, "sweeps": sweeps}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    fit_report(args.out)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except cs.SmokeFailure as e:
        print(f"route_sweep: {e}", file=sys.stderr)
        sys.exit(1)
