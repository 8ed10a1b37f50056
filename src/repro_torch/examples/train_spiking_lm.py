"""End to end: train a ~100M-param spiking LM for a few hundred
steps on the synthetic Markov corpus, with rolling checkpoints and a
mid-run restart to demonstrate fault-tolerant resume.

Run: PYTHONPATH=src python -m repro_torch.examples.train_spiking_lm
     [--steps 300] [--batch 8] [--seq 256] [--small] [--ckpt-dir DIR]
     [--device cpu]
(--small trains a 12M variant.)
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.configs.base import LMConfig, SpikingConfig
from repro_torch.launch.train import train_loop
from repro_torch.models import lm

LM_100M = LMConfig(
    name="spiking-lm-100m", family="dense", n_layers=12, d_model=512,
    n_heads=8, n_kv_heads=4, d_ff=1536, vocab=32000,
    spiking=SpikingConfig(t_steps=2), remat="none", loss_chunk=64)

LM_SMALL = LM_100M.replace(name="spiking-lm-12m", n_layers=6, d_model=256,
                           d_ff=768, vocab=8000)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "exspike_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = LM_SMALL if args.small else LM_100M
    n = lm.param_count(cfg)
    print(f"=== training {cfg.name}: {n/1e6:.0f}M params, spiking "
          f"(LIF tau=0.5, SDSA attention, T={cfg.spiking.t_steps}) ===")
    # No backend pin: every registry backend is differentiable (surrogate
    # gradients), so training resolves kernels per device exactly like
    # serving does.
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    # Phase 1: train to 60% of budget, checkpointing every 25 steps.
    split = int(args.steps * 0.6)
    out1 = train_loop(cfg, steps=split, batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt_dir, save_every=25, lr=1e-3,
                      log_every=25, device=args.device)
    print(f"--- phase 1 done at loss {out1['final_loss']:.4f}; simulating "
          f"a node failure + restart ---")

    # Phase 2: fresh state, auto-resume from the latest checkpoint.
    out2 = train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt_dir, save_every=25, resume=True,
                      lr=1e-3, log_every=25, device=args.device)
    first = out1["losses"][0]
    last = out2["final_loss"]
    print(f"=== done: loss {first:.4f} -> {last:.4f} over {args.steps} "
          f"steps (resumed across restart) ===")
    assert last < first, "loss should decrease end-to-end"
    return dict(first=first, last=last, losses=out1["losses"] +
                out2["losses"])


if __name__ == "__main__":
    main()
