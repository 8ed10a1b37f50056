"""Step-function factories: the training step, prefill, the decode step
and the bucketed prefill that admits a request.

Each closes over the config and returns a plain function on tensors
(there is no jit cache to share: the same function object serves every
caller). With `mesh=` each resolves its kernels mesh-aware
(`_under_mesh`), and the mesh is the ambient one an expert-parallel MoE
reads. On a one-process mesh it steers resolution only. On a rank mesh
(`launch.mesh.RankMesh`) the training step is data-parallel: the loss
is the global one over every data rank's rows, and the gradients are
summed over the `data` group (see `make_train_step`). Placing params
beyond the expert banks is `launch.mesh.MULTI_PROCESS_ITEM`.
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
    tree. Each microbatch's loss is divided by its labelled positions
    summed over the `data` group (labels of -1 make counts differ by
    rank), so the gradients summed over that group are those of the
    global loss; `metrics["loss"]` is that global loss. The clip's
    global norm counts a replicated leaf once and sums an expert bank's
    squares over the `model` group. Collectives: `all_reduce` alone."""
    if opt_cfg is None:
        opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype)
    spk = cfg.spiking.enabled if spiking is None else spiking
    m = max(1, cfg.microbatches)
    from repro_torch.launch.mesh import RankMesh
    ranked = isinstance(mesh, RankMesh)
    if ranked:
        from repro_torch.launch import distributed
        data_group = mesh.axis_group("data") if "data" in mesh.shape \
            else None
        sliced: list = []            # per leaf: an expert bank's slice?

    def data_sum(t):
        return distributed.all_reduce_(t, data_group) \
            if data_group is not None else t

    def grads_of(params, batch):
        leaves = adamw.leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)

        def one(mb):
            if ranked:
                tot, cnt = lm.loss_terms(cfg, params, mb, spk)
                cnt = data_sum(cnt.detach().clone())
                loss = tot / torch.clamp(cnt, min=1.0)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
                return data_sum(tot.detach().clone()) / \
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
            grads = [data_sum(g) for g in grads]
        return loss, adamw.unflatten(params, grads)

    def norm_of(params, grads):
        """The clip's global norm: `adamw.global_norm` off a rank mesh;
        on one, the replicated leaves' squares plus the expert banks'
        summed over the `model` group."""
        if not ranked:
            return adamw.global_norm(grads)
        if not sliced:
            # the specs of the whole tree: a rank's own banks may no
            # longer divide the model axis
            from repro_torch.runtime import sharding
            whole = lm.abstract_params(cfg)
            sliced.extend(sharding.sliced_leaves(
                whole, sharding.param_specs(cfg, whole, mesh), mesh))
        flat = adamw.leaves(grads)
        rep = [g for g, s in zip(flat, sliced) if not s]
        own = [g for g, s in zip(flat, sliced) if s]
        sq = sum(torch.sum(torch.square(x.float())) for x in rep)
        if own:
            sq = sq + distributed.all_reduce_(
                sum(torch.sum(torch.square(x.float())) for x in own),
                mesh.axis_group("model"))
        return torch.sqrt(sq)

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
    if ranked:
        raise NotImplementedError(
            "gradient compression over a rank mesh is not ported "
            "(the data-parallel step sums uncompressed gradients)")

    def train_step_ef(params, opt_state, ef_state, batch):
        loss, grads = grads_of(params, batch)
        wire, scales, new_ef = grad_compress.compress(grads, ef_state)
        grads = grad_compress.decompress(wire, scales)
        lr_scale = schedule_fn(opt_state.step)
        new_params, new_opt = adamw.update(grads, opt_state, params, opt_cfg,
                                           lr_scale)
        metrics = {"loss": loss, "grad_norm": adamw.global_norm(grads)}
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
