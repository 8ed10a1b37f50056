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
mesh, and the data pipeline splits over its `data` axis. A one-process
mesh over several devices is refused, naming the rank mesh.

Over a rank mesh (`launch.mesh.RankMesh`, one process a rank) the loop
is data-parallel: every rank draws the params from the seed and keeps
its `local_params` part (its slice of the expert banks), the step sums
the gradients over the `data` group (`steps.make_train_step`), and the
batch is the reference's: shard 0's ``batch // n_data`` rows, of which
each data rank takes its contiguous slice where the count divides and
all of them where it does not (as `batch_axes` replicates). Rank 0
writes each checkpoint, the full tree gathered over `model`, and the
ranks meet at a barrier after it; every rank resumes from the same
snapshot.

A checkpoint's step is the number of updates its state has taken, so a
resumed run starts its data pipeline and schedule at that step and
replays no batch (the reference labels its in-loop saves one lower).

Before it draws anything on the card, the loop checks that the params,
their gradients and AdamW's moments fit there (`train_state_bytes`) and
refuses a config that does not, naming what it needs: full-depth
qwen2-moe-a2.7b needs about 172 GB, so one card trains only its reduced
config (`--reduced`) until training spans several cards.

CLI: python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 50 \\
        --reduced --batch 8 --seq 128 [--resume] [--ckpt-dir ...] \\
        [--dense] [--device cpu] \\
        [--nproc N --mesh DxM --dist-backend {nccl,gloo}]
`--nproc N` spawns N ranks on a (D, M) rank mesh (D x M = N): under
``nccl`` one a card, under ``gloo`` on `--device` (the CPU, or one card
shared by every rank). Under `torchrun` (its environment set) the
process is one rank already: pass `--mesh` and `--dist-backend` alone.
"""
from __future__ import annotations

import argparse
import functools
import os
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import LMConfig
from repro_torch.data import pipeline, synthetic
from repro_torch.launch import distributed, steps as steps_mod
from repro_torch.launch.mesh import MULTI_PROCESS_ITEM, Mesh, RankMesh, \
    make_host_mesh, refuse_distinct_devices
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


def train_state_bytes(cfg: LMConfig, mesh: Optional[Mesh] = None) -> int:
    """Bytes the training state alone needs on the device: the params,
    their gradients (in the params' dtypes, plus an f32 sum of them when
    `cfg.microbatches` > 1) and AdamW's two moments in
    `cfg.opt_state_dtype`. Activations come on top. On a rank mesh, a
    rank's own leaves (`sharding.local_params`): a checkpoint's save and
    restore hold one whole expert bank beyond them at a time (rank 0's
    save copies the whole state to host memory)."""
    moment = 2 if cfg.opt_state_dtype == "bfloat16" else 4
    total = 0
    tree = lm.abstract_params(cfg)
    if isinstance(mesh, RankMesh):
        tree = sharding.local_params(
            tree, sharding.param_specs(cfg, tree, mesh), mesh)
    for p in adamw.leaves(tree):
        grad = p.element_size() + (4 if cfg.microbatches > 1 else 0)
        total += p.numel() * (p.element_size() + grad + 2 * moment)
    return total


def rank_rows(rows: int, mesh: RankMesh) -> slice:
    """A data rank's rows of a step's `rows`: its contiguous slice where
    the data axis divides them, all of them where it does not."""
    n = mesh.shape.get("data", 1)
    if rows % n:
        return slice(None)
    c = mesh.coords()["data"] if n > 1 else 0
    per = rows // n
    return slice(c * per, (c + 1) * per)


def _device_bytes(dev) -> Optional[int]:
    """The card's memory, None on the CPU."""
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def train_loop(cfg: LMConfig, *, steps: int = 50, batch: int = 8,
               seq: int = 128, seed: int = 0, ckpt_dir: Optional[str] = None,
               save_every: int = 20, resume: bool = False,
               log_every: int = 10, lr: float = 1e-3, mesh=None,
               spiking: Optional[bool] = None, device="cuda") -> dict:
    ranked = isinstance(mesh, RankMesh)
    dev = mesh.device if ranked else resolve_device(device)
    mesh = mesh if mesh is not None else training_mesh(dev)
    refuse_distinct_devices(mesh, "training")
    spk = cfg.spiking.enabled if spiking is None else spiking
    lm.refuse_rank_cut(cfg, mesh, spk)
    need, have = train_state_bytes(cfg, mesh), _device_bytes(dev)
    if have is not None and need > have:
        raise RuntimeError(
            f"{cfg.name}: its params, gradients and AdamW moments need "
            f"{need / 1e9:.1f} GB, beyond the {have / 1e9:.1f} GB of {dev}; "
            f"train its reduced config (--reduced), split its experts "
            f"over more ranks (a rank mesh's model axis), or wait for "
            f"the placement of its other leaves ({MULTI_PROCESS_ITEM})")
    # Training resolves through the registry as inference does, and under
    # the mesh: gates run per data shard, and a degrade walks its chain
    # and names itself ("backend<-requested").
    who = f"[train rank {mesh.rank}]" if ranked else "[train]"
    if spk:
        from repro_torch.kernels import dispatch
        resolved = " ".join(
            f"{op}={be}" for op, be in
            dispatch.resolved_backends(dev, mesh=mesh).items())
        print(f"{who} dispatch backends on {dev} (mesh-aware): {resolved}")

    params = lm.init_params(cfg, seed, device=dev)
    pspecs = sharding.param_specs(cfg, params, mesh)
    problems = sharding.validate_specs(params, pspecs, mesh)
    if problems:
        raise ValueError(f"param specs do not fit {mesh}: {problems[:3]}")
    if ranked:
        params = sharding.local_params(params, pspecs, mesh)
    opt_cfg = adamw.AdamWConfig(lr=lr, state_dtype=cfg.opt_state_dtype)
    opt_state = adamw.init(params, opt_cfg)
    schedule_fn = functools.partial(
        sched.warmup_cosine, warmup_steps=max(2, steps // 20),
        total_steps=steps)
    step_fn = steps_mod.make_train_step(cfg, opt_cfg, schedule_fn,
                                        spiking=spk, mesh=mesh)

    mgr = CheckpointManager(ckpt_dir, save_every=save_every,
                            writer=not ranked or mesh.rank == 0) \
        if ckpt_dir else None
    sspecs = sharding.state_specs(pspecs)

    def save(step):
        """Rank 0 writes the full tree; on a rank mesh every rank takes
        part in the gather of each leaf in turn and waits at a barrier
        for the commit."""
        if not ranked:
            mgr.save(step, (params, opt_state))
            return
        mgr.save(step, leaves=sharding.full_leaves((params, opt_state),
                                                   sspecs, mesh))
        mgr.wait()
        distributed.barrier()

    start_step = 0
    if mgr and resume:
        # Fresh tensors: the restored tree shares no storage with the
        # initial one.
        if ranked:
            # the whole tree's shapes alone: each leaf is cut to this
            # rank's part as it is read
            from repro_torch.runtime import elastic
            whole = lm.abstract_params(cfg)
            latest, restored = elastic.reshard_restore(
                cfg, mgr, (whole, adamw.init(whole, opt_cfg)), mesh)
        else:
            latest, restored = mgr.restore_latest((params, opt_state), dev)
        if latest is not None:
            params, opt_state = restored
            start_step = latest
            print(f"{who} resumed from step {latest}")

    # As the reference's loop: the pipeline splits over the mesh's data
    # axis and feeds shard 0's rows; on a rank mesh each data rank keeps
    # its slice of them (`rank_rows`).
    n_shards = mesh.shape.get("data", 1)
    local_b = max(1, batch // n_shards)
    rows = rank_rows(local_b, mesh) if ranked else slice(None)

    def make_batch(shard, step):
        b = synthetic.lm_batch(seed, shard, step, local_b, seq, cfg.vocab)
        return {k: v[rows] for k, v in b.items()}

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
                print(f"{who} step {step:5d} loss {loss:.4f} "
                      f"({report['seconds']:.2f}s)")
            if mgr and step + 1 < steps and mgr.should_save(step + 1):
                save(step + 1)
    finally:
        pipe.stop()
    if mgr:
        save(steps)
        mgr.wait()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "seconds": time.time() - t_start, "params": params,
            "opt_state": opt_state, "mesh": mesh,
            "straggler_flags": mon.flagged_steps}


# How long `--nproc`'s ranks may run before the launcher ends them (a
# hung rank must not hold the card forever).
SPAWN_DEADLINE_S = 24 * 3600


def _parse_mesh(text: str) -> tuple:
    d, m = (int(x) for x in text.lower().split("x"))
    return d, m


def _train_rank(kwargs: dict, arch: str, reduced: bool, mesh_shape: tuple,
                ) -> dict:
    """One rank of `--nproc`: the loop over the rank mesh; the losses come
    back to the launcher."""
    from repro_torch.launch.mesh import make_rank_mesh
    cfg = registry.get_reduced(arch) if reduced else registry.get_config(arch)
    mesh = make_rank_mesh(mesh_shape, ("data", "model"))
    out = train_loop(cfg, mesh=mesh, **kwargs)
    return {"losses": out["losses"], "seconds": out["seconds"]}


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
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks on a rank mesh")
    ap.add_argument("--mesh", default=None,
                    help="the rank mesh as DxM (data x model); default "
                         "Nx1")
    ap.add_argument("--dist-backend", choices=distributed.BACKENDS,
                    default=None, help="the process group's backend "
                    "(named explicitly: none is chosen for you)")
    args = ap.parse_args()
    kwargs = dict(steps=args.steps, batch=args.batch, seq=args.seq,
                  ckpt_dir=args.ckpt_dir, resume=args.resume, lr=args.lr,
                  spiking=None if not args.dense else False)
    torchrun = distributed.under_torchrun()
    if args.nproc or torchrun:
        if args.dist_backend is None:
            ap.error("--nproc and torchrun need --dist-backend nccl|gloo")
        n = args.nproc or int(os.environ["WORLD_SIZE"])
        shape = _parse_mesh(args.mesh) if args.mesh else (n, 1)
        if shape[0] * shape[1] != n:
            ap.error(f"--mesh {args.mesh} does not hold {n} ranks")
        rank_args = (kwargs, args.arch, args.reduced, shape)
        if torchrun:
            distributed.init(args.dist_backend, args.device)
            me = distributed.rank()
            try:
                out = _train_rank(*rank_args)
            finally:
                distributed.shutdown()
            if me != 0:
                return
        else:
            out = distributed.spawn(_train_rank, n,
                                    backend=args.dist_backend,
                                    device=args.device,
                                    timeout_s=SPAWN_DEADLINE_S,
                                    args=rank_args)[0]
        print(f"[train] done on {n} ranks ({args.dist_backend}): final loss "
              f"{out['losses'][-1]:.4f} in {out['seconds']:.1f}s")
        return
    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    out = train_loop(cfg, device=args.device, **kwargs)
    print(f"[train] done: final loss {out['final_loss']:.4f} "
          f"in {out['seconds']:.1f}s")


if __name__ == "__main__":
    main()
