"""Training launcher: the real loop the examples drive, the port of
`repro.launch.train`.

Wires together the synthetic data pipeline (prefetched on a thread),
AdamW with a warmup-cosine schedule, the LM's chunked loss, rolling async
checkpoints with auto-resume and straggler monitoring. Plain PyTorch on
one explicit device: the card by default, where the fires and the causal
SDSA run the hand-written kernels; `device="cpu"` runs their plain
versions. Asking for the card where there is none raises; nothing falls
back to the CPU on its own. A device mesh waits for ROADMAP queue 1 item
8.

A checkpoint's step is the number of updates its state has taken, so a
resumed run starts its data pipeline and schedule at that step and
replays no batch (the reference labels its in-loop saves one lower).

CLI: python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 50 \\
        --reduced --batch 8 --seq 128 [--resume] [--ckpt-dir ...] \\
        [--dense] [--device cpu]
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Optional

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import LMConfig
from repro_torch.data import pipeline, synthetic
from repro_torch.launch import steps as steps_mod
from repro_torch.models import lm
from repro_torch.optim import adamw, schedule as sched
from repro_torch.runtime.straggler import StragglerMonitor


def train_loop(cfg: LMConfig, *, steps: int = 50, batch: int = 8,
               seq: int = 128, seed: int = 0, ckpt_dir: Optional[str] = None,
               save_every: int = 20, resume: bool = False,
               log_every: int = 10, lr: float = 1e-3, mesh=None,
               spiking: Optional[bool] = None, device="cuda") -> dict:
    steps_mod._no_mesh(mesh)
    dev = resolve_device(device)
    spk = cfg.spiking.enabled if spiking is None else spiking
    if spk:
        from repro_torch.kernels import dispatch
        resolved = " ".join(f"{op}={be}" for op, be in
                            dispatch.resolved_backends(dev).items())
        print(f"[train] dispatch backends on {dev}: {resolved}")

    params = lm.init_params(cfg, seed, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=lr, state_dtype=cfg.opt_state_dtype)
    opt_state = adamw.init(params, opt_cfg)
    schedule_fn = functools.partial(
        sched.warmup_cosine, warmup_steps=max(2, steps // 20),
        total_steps=steps)
    step_fn = steps_mod.make_train_step(cfg, opt_cfg, schedule_fn,
                                        spiking=spk)

    mgr = CheckpointManager(ckpt_dir, save_every=save_every) \
        if ckpt_dir else None
    start_step = 0
    if mgr and resume:
        # Fresh tensors: the restored tree shares no storage with the
        # initial one.
        latest, restored = mgr.restore_latest((params, opt_state), dev)
        if latest is not None:
            params, opt_state = restored
            start_step = latest
            print(f"[train] resumed from step {latest}")

    def make_batch(shard, step):
        return synthetic.lm_batch(seed, shard, step, batch, seq, cfg.vocab)

    pipe = pipeline.ShardedPipeline(make_batch, 1, shard=0,
                                    start_step=start_step).start()
    mon = StragglerMonitor()
    losses = []
    t_start = time.time()
    it = iter(pipe)
    try:
        for step in range(start_step, steps):
            dev_batch = pipeline.device_put_batch(next(it), dev)
            mon.step_start()
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 dev_batch)
            loss = float(metrics["loss"])
            report = mon.step_end()
            losses.append(loss)
            if report.get("flagged"):
                print(f"[straggler] step {step}: {report['seconds']:.2f}s "
                      f"(ema {report.get('ema', 0):.2f}s)")
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"({report['seconds']:.2f}s)")
            if mgr and step + 1 < steps and mgr.should_save(step + 1):
                mgr.save(step + 1, (params, opt_state))
    finally:
        pipe.stop()
    if mgr:
        mgr.save(steps, (params, opt_state))
        mgr.wait()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "seconds": time.time() - t_start, "params": params,
            "opt_state": opt_state,
            "straggler_flags": mon.flagged_steps}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dense", action="store_true",
                    help="dense baseline instead of spiking")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card; "
                         "'cpu' runs the plain PyTorch versions)")
    args = ap.parse_args()
    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    out = train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt_dir=args.ckpt_dir, resume=args.resume, lr=args.lr,
                     spiking=None if not args.dense else False,
                     device=args.device)
    print(f"[train] done: final loss {out['final_loss']:.4f} "
          f"in {out['seconds']:.1f}s")


if __name__ == "__main__":
    main()
