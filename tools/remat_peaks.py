#!/usr/bin/env python3
"""Peak memory and time of xlstm-350m's `loss_fn` backward under remat
"full" and "none" on one card, for the `repro_torch` package under SRC:
the step of `chip_smoke.py` (s1) (uncut, spiking at XLSTM_FIRING_VTH,
S_TRAIN_BATCH x XLSTM_TRAIN_SEQ tokens, weights from SEED).

    python3 tools/remat_peaks.py [SRC]        # SRC defaults to src

To weigh a change of the remat against its parent, unpack the parent
into a directory that .gitignore lists and run both trees in one call:

    mkdir -p build/parent && git archive PARENT | tar -x -C build/parent
    python3 tools/remat_peaks.py build/parent/src
    python3 tools/remat_peaks.py src

Prints one JSON line a pass (a warm-up under "none", then "full" and
"none"), with the card's name and power limit: the
peak (absolute, and above what was held before the pass), the seconds,
the kernels' launches and a SHA-256 over the loss and every gradient, so
that two trees' gradients can be compared bit for bit.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                      else os.path.join(ROOT, "src"))
# chip_smoke.py's (s1) step; its module imports its own checkout's
# package, so its values are repeated here rather than imported.
ARCH, FIRING_VTH, BATCH, SEQ, SEED = "xlstm-350m", 0.02, 8, 32, 0


def main():
    sys.path.insert(0, SRC)
    import dataclasses
    import torch
    import repro_torch
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    if pkg != SRC:
        sys.exit(f"remat_peaks: imported repro_torch from {pkg}, not {SRC}")
    if not torch.cuda.is_available():
        sys.exit("remat_peaks: needs a CUDA card")
    from repro_torch.configs.registry import get_config
    from repro_torch.data import pipeline, synthetic
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    base = get_config(ARCH)
    cfg = base.replace(spiking=dataclasses.replace(base.spiking,
                                                   lif_vth=FIRING_VTH))
    params = lm.init_params(cfg, seed=SEED, device=dev)
    batch = pipeline.device_put_batch(synthetic.lm_batch(
        SEED, 0, 0, BATCH, SEQ, cfg.vocab), dev)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    # The first pass (untimed) builds or loads the kernels and warms the
    # libraries; the next two are reported.
    for remat in ("none", "full", "none"):
        c = cfg.replace(remat=remat)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = lm.loss_fn(c, params, batch, True)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        digest = hashlib.sha256()
        for t in (loss, *grads):
            digest.update(t.detach().float().cpu().numpy().tobytes())
        print(json.dumps(dict(
            what="remat_peaks_tool", card=card, src=SRC, arch=cfg.name,
            layers=cfg.n_layers, batch=BATCH, seq=SEQ, remat=remat,
            loss=loss.item(), peak=peak, held=held, own_peak=peak - held,
            seconds=seconds,
            launches={k: n for k, n in launch_counts().items() if n},
            sha256=digest.hexdigest())), flush=True)
        del loss, grads


if __name__ == "__main__":
    main()
