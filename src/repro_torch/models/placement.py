"""Tensor-parallel and FSDP execution on a rank mesh: the collectives that
the reference's specs imply and GSPMD inserts, written out.

`runtime.sharding.local_params` gives each rank its shard of every leaf
by `param_specs` (the shard JAX places on the same mesh position). This
module runs the LM on those shards. `of(cfg)` reads the ambient mesh
(`launch.mesh.current_mesh`) and returns a `Placement`:

  * off a rank mesh, or on one of one `model` position without FSDP, it
    does nothing: every helper below is the one-process code, bit for
    bit;
  * tensor parallelism (`model` > 1, not `pure_fsdp`): attention runs
    each rank's own heads (when both the query and the KV heads split
    evenly), the MLP (and an MoE's shared experts) each rank's own
    columns of d_ff; each such pair of products enters through
    `ReplicaCopy` (identity forward, its cotangent summed over `model`)
    and leaves through `PartialSum` (the row-split product's partials
    summed over `model` in rank order, the Megatron pair). The embedding
    looks up its own vocab rows (the others zero) and sums over `model`;
    the LM head computes its own vocab columns and all-gathers them, so
    the loss and the served logits see whole rows. The expert banks stay
    on `moe_apply_shard_map`'s expert parallelism;
  * every other split dim is gathered where it is used (`gathered`): an
    FSDP `data` dim, pure FSDP's whole-mesh dim, and the `model` dims of
    leaves whose consumer runs whole on every model rank (the SSM blocks,
    cross-attention, attention whose heads do not split evenly, a
    frontend projection). The gather's backward sums the gradient over
    the ranks of a batch axis (a reduce-scatter) and keeps this rank's
    block over any other axis (every rank there computed the same
    gradient);
  * the block weights are gathered inside the group loop
    (`models.lm._run_blocks`), one group at a time: a group that gathers
    recomputes its forward in the backward (as `remat="full"` does), so
    its gathered weights are freed after the group in the forward and
    after its backward in the recompute. The LM head is gathered once
    for the loss (`lm.loss_terms`), as the reference's `loss_fn` does.

`witness()` is the yardstick of the row-split products: on a one-process
mesh with a `model` axis of m positions, each tensor-parallel pair runs
once per model position on that position's cut of the whole weights and
the partial outputs are summed in f32 in position order, rounded once
(`position_sum`); a decode state is cut and re-joined on its heads the
same way. On two model ranks the rank run's all-reduce sums the same
two partials in f32 (a sum of two has one order), so the two agree bit
for bit; on more, the all-reduce's order is the backend's, and the two
agree wherever the f32 sum is exact, which it nearly always is.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import LMConfig

ATTN_CUTS = {"w_q": -1, "w_k": -1, "w_v": -1, "w_o": -2}
MLP_CUTS = {"w_gate": -1, "w_up": -1, "w_down": -2}
_ATTN = frozenset(ATTN_CUTS)
_MLP = frozenset(MLP_CUTS)

_WITNESS = [False]


@contextlib.contextmanager
def witness():
    """While active, a one-process mesh with a `model` axis runs every
    tensor-parallel product per model position and sums the partials in
    position order (see the module doc)."""
    _WITNESS.append(True)
    try:
        yield
    finally:
        _WITNESS.pop()


# ------------------------------------------------------------ collectives
def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over the ranks of `group` (an all-reduce), as a new
    tensor of `t`'s dtype. The sum runs in f32 and is rounded once: a
    bf16 all-reduce would round after every addition, in an order the
    backend picks, while the f32 sum of a few bf16 partials is nearly
    always exact, and so the same bits in every order. It moves twice a
    bf16 tensor's bytes."""
    from repro_torch.launch import distributed
    acc = t.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    return distributed.all_reduce_(acc, group).to(t.dtype)


def position_sum(parts) -> torch.Tensor:
    """The one-process form of `group_sum`: `parts` (one per model
    position) summed in position order in f32 and rounded once to their
    dtype; None parts (no cotangent) count as zeros."""
    acc, dtype = None, None
    for part in parts:
        if part is not None:
            dtype = part.dtype
            acc = part.float() if acc is None else acc + part.float()
    return acc if acc is None else acc.to(dtype)


class ReplicaCopy(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over `group`
    (`group_sum`): a replicated operand each rank feeds only its own
    shard's products."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return group_sum(g, ctx.group), None


class PartialSum(torch.autograd.Function):
    """The partial outputs summed over `group` (`group_sum`); the
    backward passes the cotangent through, as every rank holds the whole
    of it."""

    @staticmethod
    def forward(ctx, partial, group):
        return group_sum(partial, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Split(torch.autograd.Function):
    """`m` identical copies of x, for the one-process forms of the ranks'
    products: each model position takes its own copy (where a rank's
    `ReplicaCopy` stands), so the cotangent of each position's products
    is summed there first, as on its rank, and the backward then sums
    the positions' cotangents (`position_sum`)."""

    @staticmethod
    def forward(ctx, x, m):
        return tuple(x.view_as(x) for _ in range(m))

    @staticmethod
    def backward(ctx, *grads):
        return position_sum(grads), None


class _GatherLast(torch.autograd.Function):
    """Column blocks all-gathered along the last dim over `group`; the
    backward keeps this rank's block of the cotangent (every rank holds
    the same whole cotangent)."""

    @staticmethod
    def forward(ctx, y, group):
        import torch.distributed as dist
        from repro_torch.launch import distributed
        ctx.n, ctx.i = y.shape[-1], dist.get_rank(group)
        return distributed.all_gather(y.contiguous(), -1, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.i * ctx.n, ctx.n), None


class _GatherLeaf(torch.autograd.Function):
    """A leaf's shard all-gathered along `dim` over `group`. The backward
    reduce-scatters the cotangent where the group's ranks ran other batch
    rows (`summed`), and keeps this rank's block where they ran the same
    rows (the same cotangent on each)."""

    @staticmethod
    def forward(ctx, w, dim, group, summed):
        import torch.distributed as dist
        from repro_torch.launch import distributed
        ctx.dim, ctx.group, ctx.summed = dim, group, summed
        ctx.n, ctx.i = w.shape[dim], dist.get_rank(group)
        return distributed.all_gather(w.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.launch import distributed
        if ctx.summed:
            return (distributed.reduce_scatter(g.contiguous(), ctx.dim,
                                               ctx.group),
                    None, None, None)
        return g.narrow(ctx.dim, ctx.i * ctx.n, ctx.n), None, None, None


def _chunk(t: torch.Tensor, dim: int, j: int, m: int) -> torch.Tensor:
    """Block j of m of `t` along `dim`, contiguous (as a rank holds it)."""
    n = t.shape[dim] // m
    return t.narrow(dim, j * n, n).contiguous()


# -------------------------------------------------------------- the specs
@functools.lru_cache(maxsize=32)
def _spec_table(cfg: LMConfig, axes: Tuple[str, ...],
                shape: Tuple[int, ...]) -> Dict[Tuple[str, ...], tuple]:
    """path -> `param_specs` spec of every leaf of `cfg`'s whole tree on a
    mesh of `shape` over `axes` (paths hold list indices as strings)."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.runtime import sharding
    from . import lm
    whole = lm.abstract_params(cfg)
    specs = sharding.param_specs(cfg, whole, abstract_mesh(shape, axes))
    return dict(sharding._spec_leaves(specs))


class Placement:
    """How one call of the LM runs on the ambient mesh (see the module
    doc): `m` model positions its tensor-parallel products split over
    (1 where none), `tp` whether they split, `ranked` whether this
    process is one rank of them (else `witness` runs them all)."""

    def __init__(self, cfg: LMConfig, mesh):
        from repro_torch.launch.mesh import Mesh, RankMesh
        self.cfg = cfg
        self.ranked = isinstance(mesh, RankMesh)
        m = mesh.shape.get("model", 1) if isinstance(mesh, Mesh) else 1
        self.witness = (not self.ranked and _WITNESS[-1] and m > 1
                        and not cfg.pure_fsdp)
        self.m = m if (self.ranked or self.witness) else 1
        self.tp = self.m > 1 and not cfg.pure_fsdp
        self.mesh = mesh if self.ranked else None
        self.group = None
        self.table: Dict[Tuple[str, ...], tuple] = {}
        self.batch = frozenset()
        if self.ranked:
            if cfg.tp2d and mesh.size > 1:
                raise NotImplementedError(
                    f"{cfg.name}: tp2d (weights split over data and model "
                    f"at once) is not placed on a rank mesh")
            if "model" in mesh.shape:
                self.group = mesh.axis_group("model")
            names = ("pod", "data", "model") if cfg.pure_fsdp \
                else ("pod", "data")
            self.batch = frozenset(a for a in names
                                   if mesh.shape.get(a, 1) > 1)
            if mesh.size > 1:
                self.table = _spec_table(cfg, tuple(mesh.axis_names),
                                         tuple(mesh.shape.values()))

    def heads(self) -> bool:
        """Whether attention runs each model rank's own heads."""
        return (self.tp and self.cfg.n_heads % self.m == 0
                and self.cfg.n_kv_heads % self.m == 0)

    def splits(self, width: int) -> bool:
        """Whether a product pair of hidden width `width` (an MLP's d_ff,
        the vocab) splits over the model positions, as `param_specs`
        splits its leaves."""
        return self.tp and width % self.m == 0

    def _keeps_model(self, path: Tuple[str, ...], spec) -> bool:
        """Whether the leaf at `path` (`spec` its whole tree's spec, a
        stacked block leaf's group dim included) is used as its `model`
        shard (its consumer is tensor- or expert-parallel) rather than
        gathered whole."""
        if not self.tp:
            return False
        from repro_torch.runtime import sharding
        name, parent = path[-1], (path[-2] if len(path) > 1 else "")
        if parent == "attn" and name in _ATTN:
            return self.heads()
        if parent in ("mlp", "shared") and name in _MLP:
            return True
        if path == ("embed",):
            return spec[0] == "model"
        if path == ("lm_head",):
            return spec[1] == "model"
        return sharding._bank_dim(path, spec) is not None

    def gathered(self, tree, prefix: Tuple[str, ...], layer: bool = False):
        """`tree` (the leaves at `prefix`; one layer's views of stacked
        leaves when `layer`) with every split dim gathered whole but the
        `model` dims a tensor-parallel consumer uses as they are."""
        if not self.table:
            return tree
        from repro_torch.runtime import sharding

        def one(path, leaf):
            full = prefix + path
            keep = self._keeps_model(full, self.table[full])
            spec = self.table[full][1:] if layer else self.table[full]
            for dim, axes, _ in sharding.splits(spec, self.mesh):
                live = {a for a in axes if self.mesh.shape[a] > 1}
                if keep and live == {"model"}:
                    continue
                summed = live <= self.batch
                if not summed and live & self.batch:
                    raise NotImplementedError(
                        f"{'.'.join(full)}: split over {axes}, of which "
                        f"only some carry the batch")
                leaf = _GatherLeaf.apply(leaf, dim,
                                         self.mesh.axes_group(axes), summed)
            return leaf
        return sharding._map_with_path(one, tree)

    def gathers(self, prefix: Tuple[str, ...]) -> bool:
        """Whether `gathered` gathers any block leaf under `prefix`."""
        if not self.table:
            return False
        from repro_torch.runtime import sharding
        for path, spec in self.table.items():
            if path[:len(prefix)] != prefix:
                continue
            keep = self._keeps_model(path, spec)
            if any(not (keep and sharding.split_axes(spec[1:], self.mesh)
                        == {"model"})
                   for _ in sharding.splits(spec[1:], self.mesh)):
                return True
        return False


def of(cfg: LMConfig) -> Placement:
    """The placement of a call of `cfg`'s LM on the ambient mesh."""
    from repro_torch.launch.mesh import current_mesh
    return Placement(cfg, current_mesh())


def scope() -> Callable:
    """A function that runs its argument under the ambient mesh and
    `witness` state of now: a recompute in the backward then places and
    resolves as the forward did, whatever is ambient when it runs."""
    from repro_torch.launch.mesh import current_mesh, use_concrete_mesh
    mesh, wit = current_mesh(), _WITNESS[-1]

    def run(fn, *args):
        _WITNESS.append(wit)
        try:
            with use_concrete_mesh(mesh):
                return fn(*args)
        finally:
            _WITNESS.pop()
    return run


# -------------------------------------------------------- parallel blocks
def _each_leaf(fn: Callable, tree):
    """`tree` (a tensor, None, or a dict of them) with `fn` on each tensor."""
    if isinstance(tree, dict):
        return {k: _each_leaf(fn, v) for k, v in tree.items()}
    return tree if tree is None else fn(tree)


def row_parallel(pl: Placement, fn: Callable, x: torch.Tensor, p: dict,
                 cuts: Dict[str, int], state=None, state_dim: int = -2):
    """``fn(x, p[, state])``, a pair of products whose first splits its
    columns over the model positions and whose last splits its rows,
    summed over the positions: on a rank its own shard's partial output
    summed over `model` (`ReplicaCopy` / `PartialSum`); under `witness`
    every position's, on its cut of the whole leaves `cuts` names (the
    dim of each), summed in position order. The leaves of `p` that
    `cuts` does not name (qk-norm scales) are whole on every position and
    enter as `x` does (`ReplicaCopy`, or a `Split` copy a position), so
    their gradient sums every position's heads. With `state` (a
    NamedTuple of tensors) `fn` returns (partial, new state): a rank's
    state holds its own heads; the witness cuts the whole state along
    `state_dim` and joins the new ones."""
    if pl.witness:
        copies = {k: _each_leaf(lambda t: Split.apply(t, pl.m), v)
                  for k, v in p.items() if k not in cuts}
        parts, states = [], []
        for j, xj in enumerate(Split.apply(x, pl.m)):
            pj = {k: _each_leaf(lambda c: c[j], v) for k, v in copies.items()}
            for k, dim in cuts.items():
                pj[k] = _chunk(p[k], dim, j, pl.m)
            if state is None:
                part = fn(xj, pj)
            else:
                part, st = fn(xj, pj, type(state)(*(
                    _chunk(s, state_dim, j, pl.m) for s in state)))
                states.append(st)
            parts.append(part)
        acc = position_sum(parts)
        if state is None:
            return acc
        return acc, type(state)(*(torch.cat(parts, dim=state_dim)
                                  for parts in zip(*states)))
    xs = ReplicaCopy.apply(x, pl.group)
    ps = {k: v if k in cuts else _each_leaf(
        lambda t: ReplicaCopy.apply(t, pl.group) if t.requires_grad else t,
        v) for k, v in p.items()}
    if state is None:
        return PartialSum.apply(fn(xs, ps), pl.group)
    part, st = fn(xs, ps, state)
    return PartialSum.apply(part, pl.group), st


def mlp(pl: Placement, p: dict, x: torch.Tensor, width: int, *,
        spiking: bool, lif_cfg) -> torch.Tensor:
    """`layers.mlp_apply` of hidden width `width`, over the model
    positions where `width` splits (`row_parallel`)."""
    from .layers import mlp_apply

    def fn(xx, pp):
        return mlp_apply(pp, xx, spiking=spiking, lif_cfg=lif_cfg)
    if pl.splits(width):
        return row_parallel(pl, fn, x, p, MLP_CUTS)
    return fn(x, p)


def embed(pl: Placement, table: torch.Tensor,
          tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of `tokens`. On a rank holding its vocab rows,
    its own tokens' rows (zeros elsewhere) summed over `model`: one rank
    contributes each row, so the sum is the lookup exactly."""
    if not (pl.ranked and pl.splits(pl.cfg.vocab)):
        return table[tokens]
    v_loc = table.shape[0]
    local = tokens - pl.mesh.coords()["model"] * v_loc
    hit = (local >= 0) & (local < v_loc)
    rows = table[local.clamp(0, v_loc - 1)]
    return PartialSum.apply(torch.where(hit[..., None], rows,
                                  rows.new_zeros(())), pl.group)


def logits(pl: Placement, w_head: torch.Tensor,
           h: torch.Tensor) -> torch.Tensor:
    """f32 logits ``h @ w_head``. Where the vocab splits over the model
    positions each computes its own columns, joined along the vocab
    (all-gathered on a rank, concatenated under `witness`)."""
    if pl.splits(pl.cfg.vocab):
        if pl.witness:
            return torch.cat([hj @ _chunk(w_head, -1, j, pl.m).to(h.dtype)
                              for j, hj in enumerate(Split.apply(h, pl.m))],
                             dim=-1).float()
        y = ReplicaCopy.apply(h, pl.group) @ w_head.to(h.dtype)
        return _GatherLast.apply(y, pl.group).float()
    return (h @ w_head.to(h.dtype)).float()
