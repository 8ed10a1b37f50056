"""AdamW, the port of `repro.optim.adamw`: the same config, state and math
over the same dict-of-tensors param tree.

  * moments in float32 or bfloat16 (`state_dtype`),
  * global-norm clipping fused into the update,
  * bias corrections in float32 from the integer step,
  * decoupled weight decay on matrices (`ndim >= 2`) only.

Unlike the JAX version, `update` works IN PLACE under `torch.no_grad()`:
it writes the new values into the param and moment tensors it is given
(which may be autograd leaves) and returns those same trees, so a step
allocates no second copy of the params or the moments.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the params' device
    mu: Any              # first moment (param tree)
    nu: Any              # second moment (param tree)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"     # "float32" | "bfloat16"


_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a dict/list tree, in the order `jax.tree.leaves`
    walks the same tree (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(tree, flat) -> Any:
    """The tree of `tree`'s shape whose leaves are `flat`, in `leaves`
    order (the inverse of `leaves`)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def init(params: Any, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    dt = _STATE_DTYPES[cfg.state_dtype]
    device = leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=_tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                           device=p.device), params),
        nu=_tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                           device=p.device), params))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def update(grads: Any, state: AdamWState, params: Any,
           cfg: AdamWConfig = AdamWConfig(),
           lr_scale: torch.Tensor | float = 1.0,
           gnorm: torch.Tensor | None = None) -> Tuple[Any, AdamWState]:
    """Returns (params, new_state), with params and moments updated in
    place. lr_scale: schedule multiplier. `gnorm`: the clip's global norm
    where `grads` is one rank's part of a larger tree (a data-parallel
    step over expert-parallel banks); None takes `global_norm(grads)`."""
    step = state.step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    lr = cfg.lr * lr_scale
    for g, m, v, p in zip(leaves(grads), leaves(state.mu), leaves(state.nu),
                          leaves(params)):
        g = g.float() * clip
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / b1c
        vhat = v32 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 2:   # decoupled decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
