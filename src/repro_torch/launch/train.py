"""Training launcher: the real loop the examples drive, the port of
`repro.launch.train`.

Wires together the synthetic data pipeline (prefetched on a thread),
AdamW with a warmup-cosine schedule, the LM's chunked loss, rolling async
checkpoints with auto-resume and straggler monitoring. Plain PyTorch on
one explicit device: the card by default, where the fires and the causal
SDSA run the hand-written kernels; `device="cpu"` runs their plain
versions. Asking for the card where there is none raises; nothing falls
back to the CPU on its own. The step resolves its kernels under a mesh
(by default `training_mesh`: the host mesh of the training card alone,
however many cards the host has): one data shard on one card resolves
as no mesh does. The param specs are computed and validated against the
mesh, and the data pipeline splits over its `data` axis; a mesh over
several cards is refused (the port has no data-parallel all-reduce yet:
`launch.mesh.MULTI_PROCESS_ITEM`).

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

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import LMConfig
from repro_torch.data import pipeline, synthetic
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import MULTI_PROCESS_ITEM, Mesh, make_host_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw, schedule as sched
from repro_torch.runtime import sharding
from repro_torch.runtime.straggler import StragglerMonitor


def training_mesh(dev) -> Mesh:
    """The default mesh of `train_loop`: the host mesh of the training
    device alone (one position), whatever other cards the host has."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return make_host_mesh(device=dev)


def train_loop(cfg: LMConfig, *, steps: int = 50, batch: int = 8,
               seq: int = 128, seed: int = 0, ckpt_dir: Optional[str] = None,
               save_every: int = 20, resume: bool = False,
               log_every: int = 10, lr: float = 1e-3, mesh=None,
               spiking: Optional[bool] = None, device="cuda") -> dict:
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else training_mesh(dev)
    if len(mesh.distinct_devices()) > 1:
        raise NotImplementedError(
            f"training over a mesh of {len(mesh.distinct_devices())} "
            f"devices needs a data-parallel all-reduce "
            f"({MULTI_PROCESS_ITEM})")
    spk = cfg.spiking.enabled if spiking is None else spiking
    # Training resolves through the registry as inference does, and under
    # the mesh: gates run per data shard, and a degrade walks its chain
    # and names itself ("backend<-requested").
    if spk:
        from repro_torch.kernels import dispatch
        resolved = " ".join(
            f"{op}={be}" for op, be in
            dispatch.resolved_backends(dev, mesh=mesh).items())
        print(f"[train] dispatch backends on {dev} (mesh-aware): {resolved}")

    params = lm.init_params(cfg, seed, device=dev)
    pspecs = sharding.param_specs(cfg, params, mesh)
    problems = sharding.validate_specs(params, pspecs, mesh)
    if problems:
        raise ValueError(f"param specs do not fit {mesh}: {problems[:3]}")
    opt_cfg = adamw.AdamWConfig(lr=lr, state_dtype=cfg.opt_state_dtype)
    opt_state = adamw.init(params, opt_cfg)
    schedule_fn = functools.partial(
        sched.warmup_cosine, warmup_steps=max(2, steps // 20),
        total_steps=steps)
    step_fn = steps_mod.make_train_step(cfg, opt_cfg, schedule_fn,
                                        spiking=spk, mesh=mesh)

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

    # As the reference's loop: the pipeline splits over the mesh's data
    # axis and this controller feeds shard 0's rows.
    n_shards = mesh.shape.get("data", 1)
    local_b = max(1, batch // n_shards)

    def make_batch(shard, step):
        return synthetic.lm_batch(seed, shard, step, local_b, seq, cfg.vocab)

    pipe = pipeline.ShardedPipeline(make_batch, n_shards, shard=0,
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
            "opt_state": opt_state, "mesh": mesh,
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
