"""Step-function factories: the training step, prefill, the decode step
and the bucketed prefill that admits a request.

Each closes over the config and returns a plain function on tensors
(there is no jit cache to share: the same function object serves every
caller). With `mesh=` each resolves its kernels mesh-aware
(`_under_mesh`), and the mesh is the ambient one an expert-parallel MoE
reads. On a one-process mesh it steers resolution only. On a rank mesh
(`launch.mesh.RankMesh`) each rank holds its `local_params` shard of
every leaf and the model runs on them (`models.placement`); the training
step is data-parallel over the batch axes: the loss is the global one
over every batch rank's rows, and each gradient is summed over the batch
ranks that do not split its leaf (see `make_train_step`).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import lm
from repro_torch.optim import adamw, grad_compress, schedule as sched


def _under_mesh(fn: Callable, mesh) -> Callable:
    """`fn` with every registry call inside it resolved mesh-aware: the
    ambient `dispatch.use_mesh(mesh)` is pushed around each call (per-shard
    gates, mesh-aware backends only), so a degrade on a ragged shard grid
    walks its chain and names itself instead of running dense math.
    `mesh` is a `launch.mesh.Mesh` or an int shard count; None returns
    `fn` itself."""
    if mesh is None:
        return fn
    from repro_torch.launch.mesh import Mesh
    if not isinstance(mesh, (Mesh, int)) or isinstance(mesh, bool):
        raise TypeError(f"mesh must be a launch.mesh.Mesh or a shard "
                        f"count, got {type(mesh).__name__}")
    from repro_torch.kernels import dispatch

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with dispatch.use_mesh(mesh):
            return fn(*args, **kwargs)
    return wrapped


def make_train_step(
    cfg: LMConfig,
    opt_cfg: Optional[adamw.AdamWConfig] = None,
    schedule_fn: Callable = sched.constant,
    spiking: Optional[bool] = None,
    grad_compression: bool = False,
    mesh=None,
) -> Callable:
    """train_step(params, opt_state, [ef_state,] batch) ->
    (params, opt_state, [ef_state,] metrics).

    Gradients come from `torch.autograd.grad` over the param leaves (each
    made an autograd leaf that requires grad, in place, if it is not
    one); `adamw.update` then writes the params and moments in place, so
    the returned params are the tensors passed in. With
    `cfg.microbatches` m > 1 the batch splits into m microbatches along
    axis 0, their f32 gradients and losses are summed in order and
    divided by m. `metrics` holds `loss` and `grad_norm` as device
    tensors: nothing is read to the host inside the step. `mesh`: the
    step resolves its kernels mesh-aware (`_under_mesh`).

    On a rank mesh each rank passes its own rows and its `local_params`
    tree. The batch axes are (pod, data), and `model` too under
    `pure_fsdp`. Each microbatch's loss is divided by its labelled
    positions summed over the batch ranks (labels of -1 make counts
    differ by rank), so the gradients summed over them are those of the
    global loss; `metrics["loss"]` is that global loss. A leaf gathered
    over a batch axis has its gradient reduce-scattered there by the
    gather's backward; each gradient is then all-reduced over the batch
    axes its leaf is not split over. Every such sum runs in the wider
    type and is rounded once (`placement.group_sum`), so it has the same
    bits in any order. The clip's global norm sums each leaf's squares
    over the ranks of the axes it is split over.

    `grad_compression=True` adds the error-feedback state:
    train_step(params, opt_state, ef_state, batch). The step's gradient
    (on a rank mesh, after the batch sum) is compressed to int8 values
    with one scale a leaf (`optim.grad_compress`), decompressed, and
    clipped by `norm_of` the decompressed gradients, which is
    `metrics["grad_norm"]`. On a rank mesh each leaf's scale reads the
    max |g + e| over the whole leaf: the rank's max all-reduced with MAX
    over the axes the leaf is split over (`leaf_axes`; none for a
    replicated leaf), so every rank's wire, scales and error-feedback
    blocks are the reference's compression of the summed gradient, bit
    for bit. `ef_state` is `grad_compress.init` of the rank's
    `local_params`, placed as its leaves. This does not cut the bytes on
    the wire: the batch sum runs before the compression, as the
    reference's numbers demand (its jitted step compresses the summed
    gradient), and quantising before the sum would change them."""
    if opt_cfg is None:
        opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype)
    spk = cfg.spiking.enabled if spiking is None else spiking
    m = max(1, cfg.microbatches)
    from repro_torch.launch.mesh import RankMesh
    ranked = isinstance(mesh, RankMesh)
    if ranked:
        from repro_torch.launch import distributed
        names = ("pod", "data", "model") if cfg.pure_fsdp \
            else ("pod", "data")
        # every batch axis of the mesh, one position or more: a group of
        # one rank still runs its collectives (NCCL's one-rank path)
        batch_axes = tuple(a for a in names if a in mesh.shape)
        split: list = []             # per leaf: the axes it is split over

    def batch_sum(t, axes=None):
        """t summed over the batch ranks of `axes` (all by default), a
        new tensor: in the wider type, rounded once (`group_sum`), so the
        sum has the same bits in any order the backend picks."""
        from repro_torch.models.placement import group_sum
        axes = batch_axes if axes is None else axes
        return group_sum(t, mesh.axes_group(axes)) if axes else t

    def leaf_axes() -> list:
        if not split:
            # the specs of the whole tree: a rank's own leaves may no
            # longer divide the mesh
            from repro_torch.runtime import sharding
            whole = lm.abstract_params(cfg)
            split.extend(sharding.leaf_split_axes(
                whole, sharding.param_specs(cfg, whole, mesh), mesh))
        return split

    def grads_of(params, batch):
        leaves = adamw.leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)

        def one(mb):
            if ranked:
                tot, cnt = lm.loss_terms(cfg, params, mb, spk)
                cnt = batch_sum(cnt.detach())
                loss = tot / torch.clamp(cnt, min=1.0)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
                return batch_sum(tot.detach()) / \
                    torch.clamp(cnt, min=1.0), grads
            loss = lm.loss_fn(cfg, params, mb, spk)
            # a leaf the mode never reads (qk-norm scales under SDSA) gets
            # zeros, as jax.grad gives it
            return loss.detach(), torch.autograd.grad(
                loss, leaves, allow_unused=True, materialize_grads=True)
        if m == 1:
            loss, grads = one(batch)
        else:
            micro = {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            for i in range(m):
                l_i, g_i = one({k: v[i] for k, v in micro.items()})
                loss = loss + l_i
                grads = [a + g for a, g in zip(grads, g_i)]
            loss, grads = loss / m, [g / m for g in grads]
        if ranked:
            # one leaf at a time, each unsummed gradient freed as its sum
            # (a new tensor) replaces it
            grads = list(grads)
            for i, axes in enumerate(leaf_axes()):
                grads[i] = batch_sum(grads[i], tuple(
                    a for a in batch_axes if a not in axes))
        return loss, adamw.unflatten(params, grads)

    def norm_of(params, grads):
        """The clip's global norm: `adamw.global_norm` off a rank mesh;
        on one, each leaf's squares summed over the ranks of the axes it
        is split over (a replicated leaf counted once)."""
        if not ranked:
            return adamw.global_norm(grads)
        by_axes: dict = {}
        for g, axes in zip(adamw.leaves(grads), leaf_axes()):
            by_axes.setdefault(axes, []).append(
                torch.sum(torch.square(g.float())))
        sq = None
        for axes in sorted(by_axes, key=lambda a: (len(a), sorted(a))):
            part = sum(by_axes[axes])
            if axes:
                part = distributed.all_reduce_(
                    part, mesh.axes_group(tuple(axes)))
            sq = part if sq is None else sq + part
        return torch.sqrt(sq)

    def whole_max(amax: list) -> list:
        """Each leaf's max |g + e| over the whole leaf: the rank's own
        max all-reduced with MAX over the axes the leaf is split over,
        one all-reduce a set of axes."""
        out = list(amax)
        by_axes: dict = {}
        for i, axes in enumerate(leaf_axes()):
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes in sorted(by_axes, key=lambda a: (len(a), sorted(a))):
            idx = by_axes[axes]
            both = distributed.all_reduce_(
                torch.stack([amax[i] for i in idx]),
                mesh.axes_group(tuple(axes)), torch.distributed.ReduceOp.MAX)
            for k, i in enumerate(idx):
                out[i] = both[k]
        return out

    if not grad_compression:
        def train_step(params, opt_state, batch):
            loss, grads = grads_of(params, batch)
            gnorm = norm_of(params, grads)
            lr_scale = schedule_fn(opt_state.step)
            new_params, new_opt = adamw.update(grads, opt_state, params,
                                               opt_cfg, lr_scale, gnorm)
            metrics = {"loss": loss, "grad_norm": gnorm}
            return new_params, new_opt, metrics
        return _under_mesh(train_step, mesh)

    def train_step_ef(params, opt_state, ef_state, batch):
        loss, grads = grads_of(params, batch)
        wire, scales, new_ef = grad_compress.compress(
            grads, ef_state, whole_max if ranked else None)
        grads = grad_compress.decompress(wire, scales)
        gnorm = norm_of(params, grads)
        lr_scale = schedule_fn(opt_state.step)
        new_params, new_opt = adamw.update(grads, opt_state, params, opt_cfg,
                                           lr_scale, gnorm)
        metrics = {"loss": loss, "grad_norm": gnorm}
        return new_params, new_opt, new_ef, metrics
    return _under_mesh(train_step_ef, mesh)


def make_prefill(cfg: LMConfig, spiking: bool, mesh=None) -> Callable:
    """serve_prefill(params, batch {"tokens": (B, N)}) -> last logits."""
    def serve_prefill(params, batch: Dict[str, Any]):
        return lm.prefill(cfg, params, batch["tokens"], spiking,
                          frontend=batch.get("frontend"))
    return _under_mesh(serve_prefill, mesh)


def make_serve_step(cfg: LMConfig, spiking: bool, mesh=None) -> Callable:
    """serve_step(params, state, token (B,), pos) -> (logits, state).

    `pos` is a scalar (aligned stepping) or a per-slot (B,) vector: the
    continuous-batching serve loop passes its per-slot positions so every
    slot decodes at its own position (see `lm.decode_step`)."""
    def serve_step(params, state, token, pos):
        return lm.decode_step(cfg, params, state, token, pos, spiking)
    return _under_mesh(serve_step, mesh)


def make_prefill_state(cfg: LMConfig, spiking: bool, mesh=None,
                       max_seq: int = 256) -> Callable:
    """prefill_state(params, tokens (B, L), length (B,)) ->
    (last logits (B, vocab), decode state at per-slot pos = length).

    The bucketed masked prefill the serve scheduler admits requests with:
    pad steps are masked out of every state write. `max_seq` sizes the
    dense KV cache (the O(d) spiking state ignores it)."""
    def prefill_state(params, tokens, length):
        return lm.prefill_chunked(cfg, params, tokens, length, spiking,
                                  max_seq)
    return _under_mesh(prefill_state, mesh)
