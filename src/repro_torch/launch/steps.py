"""Step-function factories for serving: prefill, the decode step and the
bucketed prefill that admits a request.

Each closes over the config and returns a plain function on tensors
(there is no jit cache to share: the same function object serves every
caller). `make_train_step` waits for ROADMAP queue 1 item 6, and a
device mesh for item 8.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

from repro_torch.configs.base import LMConfig
from repro_torch.models import lm

MESH_ITEM = "ROADMAP queue 1 item 8"


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"mesh-aware serving (sharded slots and mesh-aware kernel "
            f"resolution) is not ported yet ({MESH_ITEM})")


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
