"""Step-function factories: the training step, prefill, the decode step
and the bucketed prefill that admits a request.

Each closes over the config and returns a plain function on tensors
(there is no jit cache to share: the same function object serves every
caller). A device mesh waits for ROADMAP queue 1 item 8.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import lm
from repro_torch.optim import adamw, grad_compress, schedule as sched

MESH_ITEM = lm.MESH_ITEM


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"a device mesh (sharded params and slots, mesh-aware kernel "
            f"resolution) is not ported yet ({MESH_ITEM})")


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
    tensors: nothing is read to the host inside the step."""
    _no_mesh(mesh)
    if opt_cfg is None:
        opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype)
    spk = cfg.spiking.enabled if spiking is None else spiking
    m = max(1, cfg.microbatches)

    def grads_of(params, batch):
        leaves = adamw.leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)

        def one(mb):
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
        return loss, adamw.unflatten(params, grads)

    if not grad_compression:
        def train_step(params, opt_state, batch):
            loss, grads = grads_of(params, batch)
            lr_scale = schedule_fn(opt_state.step)
            new_params, new_opt = adamw.update(grads, opt_state, params,
                                               opt_cfg, lr_scale)
            metrics = {"loss": loss, "grad_norm": adamw.global_norm(grads)}
            return new_params, new_opt, metrics
        return train_step

    def train_step_ef(params, opt_state, ef_state, batch):
        loss, grads = grads_of(params, batch)
        wire, scales, new_ef = grad_compress.compress(grads, ef_state)
        grads = grad_compress.decompress(wire, scales)
        lr_scale = schedule_fn(opt_state.step)
        new_params, new_opt = adamw.update(grads, opt_state, params, opt_cfg,
                                           lr_scale)
        metrics = {"loss": loss, "grad_norm": adamw.global_norm(grads)}
        return new_params, new_opt, new_ef, metrics
    return train_step_ef


def make_prefill(cfg: LMConfig, spiking: bool, mesh=None) -> Callable:
    """serve_prefill(params, batch {"tokens": (B, N)}) -> last logits."""
    _no_mesh(mesh)

    def serve_prefill(params, batch: Dict[str, Any]):
        return lm.prefill(cfg, params, batch["tokens"], spiking,
                          frontend=batch.get("frontend"))
    return serve_prefill


def make_serve_step(cfg: LMConfig, spiking: bool, mesh=None) -> Callable:
    """serve_step(params, state, token (B,), pos) -> (logits, state).

    `pos` is a scalar (aligned stepping) or a per-slot (B,) vector: the
    continuous-batching serve loop passes its per-slot positions so every
    slot decodes at its own position (see `lm.decode_step`)."""
    _no_mesh(mesh)

    def serve_step(params, state, token, pos):
        return lm.decode_step(cfg, params, state, token, pos, spiking)
    return serve_step


def make_prefill_state(cfg: LMConfig, spiking: bool, mesh=None,
                       max_seq: int = 256) -> Callable:
    """prefill_state(params, tokens (B, L), length (B,)) ->
    (last logits (B, vocab), decode state at per-slot pos = length).

    The bucketed masked prefill the serve scheduler admits requests with:
    pad steps are masked out of every state write. `max_seq` sizes the
    dense KV cache (the O(d) spiking state ignores it)."""
    _no_mesh(mesh)

    def prefill_state(params, tokens, length):
        return lm.prefill_chunked(cfg, params, tokens, length, spiking,
                                  max_seq)
    return prefill_state
