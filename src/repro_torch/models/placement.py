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
    the loss and the served logits see whole rows. An MoE's expert banks
    run each rank's own experts, or each rank's columns of every
    expert's d_ff, as their specs split them (`Placement.experts`,
    `models.moe`);
  * an MoE routes the global batch: each rank's rows are all-gathered
    over the batch ranks in the reference's row order (`global_rows`,
    whose backward is a reduce-scatter) and each rank keeps its own rows
    of the output (`own_rows`);
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
the partial outputs are summed in a wider type (`wide`: f32 for bf16,
f64 for f32) in position order, rounded once (`position_sum`); a decode
state is cut and re-joined on its heads the same way. The ranks'
all-reduces sum in the same wider type (`group_sum`), in an order the
backend picks; a sum of a few terms in the wider type is nearly always
exact, so the two agree bit for bit in any order (on two ranks always:
a sum of two has one order).

`witness_parts(fn, n)` is the yardstick of n batch ranks whose MoE
routes their rows together: `fn(i)`, batch rank i's forward on its own
rows, runs in one thread of this process each; every MoE layer joins
the threads' rows in rank order (`global_rows`) and each thread keeps
its own rows of its own MoE's output (`own_rows`). The threads' graphs
meet only there, as the ranks' do, so one backward through them runs
each rank's products on its own rows, and the cotangent of a thread's
MoE input is every thread's summed in the wider type, as the ranks'
reduce-scatter sums it.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, Optional, Tuple

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


class _Part:
    """Batch rank `i` of `witness_parts`' threads: `join` stands for the
    all-gather of `global_rows`, `own` for `own_rows`."""

    def __init__(self, i: int, slots: list, gate: threading.Barrier):
        self.i, self.slots, self.gate = i, slots, gate

    def join(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        # a copy of x for each thread, so that x's cotangent is their sum
        # in the wider type in thread order (`Split`), as the
        # reduce-scatter sums it
        self.slots[self.i] = Split.apply(x, len(self.slots))
        self.gate.wait()
        out = torch.cat([s[self.i] for s in self.slots], dim)
        self.gate.wait()                 # every thread has read the slots
        return out

    def own(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        n = x.shape[dim] // len(self.slots)
        return x.narrow(dim, self.i * n, n)


_PART = threading.local()


def witness_parts(fn: Callable, n: int) -> list:
    """[fn(0), ..., fn(n - 1)], each run in its own thread as batch rank i
    of n (see the module doc). The ambient mesh and `witness` are the
    caller's, shared by the threads. `fn` must not checkpoint an MoE
    layer (`remat="none"`): the backward runs on one thread, where a
    recompute cannot join the threads' rows."""
    # a thread that fails aborts the barrier; the timeout ends a hang
    slots, gate = [None] * n, threading.Barrier(n, timeout=600.0)
    out: list = [None] * n
    errors: list = []

    def run(i):
        _PART.view = _Part(i, slots, gate)
        try:
            out[i] = fn(i)
        except BaseException as e:      # noqa: BLE001 (re-raised below)
            errors.append(e)
            gate.abort()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


# ------------------------------------------------------------ collectives
def wide(dtype: torch.dtype) -> torch.dtype:
    """The type a sum of `dtype` terms over ranks runs in: f64 for f32
    (and f64), f32 for bf16 and the other narrow types."""
    return torch.float64 if dtype in (torch.float32, torch.float64) \
        else torch.float32


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over the ranks of `group` (an all-reduce), as a new
    tensor of `t`'s dtype. The sum runs in the wider type (`wide`) and is
    rounded once: an all-reduce in `t`'s dtype would round after every
    addition, in an order the backend picks, while the wider sum of a
    few partials is nearly always exact, and so the same bits in every
    order. It moves twice the tensor's bytes."""
    from repro_torch.launch import distributed
    acc = t.to(wide(t.dtype), memory_format=torch.contiguous_format,
               copy=True)
    if acc.dtype == torch.float64 and acc.is_cuda \
            and distributed.backend() == "gloo":
        # `gloo` stages card tensors in host memory anyway. A run that
        # all-reduced f64 card tensors over four `gloo` ranks on the H100
        # lost a rank, and runs with this host path did not; the cause is
        # open (PERF.md, ROADMAP queue 3)
        return distributed.all_reduce_(acc.cpu(), group).to(t.device,
                                                            t.dtype)
    return distributed.all_reduce_(acc, group).to(t.dtype)


def position_sum(parts) -> torch.Tensor:
    """The one-process form of `group_sum`: `parts` (one per model
    position or batch thread) summed in position order in the wider type
    and rounded once to their dtype; None parts (no cotangent) count as
    zeros."""
    acc, dtype = None, None
    for part in parts:
        if part is not None:
            dtype = part.dtype
            acc = part.to(wide(dtype)) if acc is None \
                else acc + part.to(wide(dtype))
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
    rows (`summed`; in the wider type, rounded once, as `group_sum`), and
    keeps this rank's block where they ran the same rows (the same
    cotangent on each)."""

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
            return (distributed.reduce_scatter(g.to(wide(g.dtype)), ctx.dim,
                                               ctx.group).to(g.dtype),
                    None, None, None)
        return g.narrow(ctx.dim, ctx.i * ctx.n, ctx.n), None, None, None


class _GatherRows(torch.autograd.Function):
    """The batch ranks' rows all-gathered along `dim` over `group`, in
    group-rank order (the reference's global row order). The backward
    reduce-scatters the cotangent, summed in the wider type (`wide`):
    each rank's own rows get the sum of every rank's cotangent of
    them."""

    @staticmethod
    def forward(ctx, x, dim, group):
        from repro_torch.launch import distributed
        ctx.dim, ctx.group = dim, group
        return distributed.all_gather(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.launch import distributed
        part = distributed.reduce_scatter(g.to(wide(g.dtype)), ctx.dim,
                                          ctx.group)
        return part.to(g.dtype), None, None


class _OwnRows(torch.autograd.Function):
    """This rank's block of the global rows along `dim` (the inverse of
    `_GatherRows`). The backward puts the cotangent at those rows and
    zeros at every other rank's."""

    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed as dist
        n = x.shape[dim] // dist.get_world_size(group)
        ctx.dim, ctx.shape = dim, x.shape
        ctx.start = dist.get_rank(group) * n
        return x.narrow(dim, ctx.start, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out.narrow(ctx.dim, ctx.start, g.shape[ctx.dim]).copy_(g)
        return out, None, None


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
        self.rows = None
        self.table: Dict[Tuple[str, ...], tuple] = {}
        self.shape = (tuple(mesh.axis_names), tuple(mesh.shape.values())) \
            if isinstance(mesh, Mesh) else None
        self.batch = frozenset()
        if self.ranked:
            if cfg.tp2d and mesh.size > 1:
                from repro_torch.launch.mesh import MULTI_PROCESS_ITEM
                raise NotImplementedError(
                    f"{cfg.name}: tp2d (weights split over data and model "
                    f"at once) is not placed on a rank mesh yet "
                    f"({MULTI_PROCESS_ITEM})")
            if "model" in mesh.shape:
                self.group = mesh.axis_group("model")
            self.batch = frozenset(_batch_axes(mesh, cfg.pure_fsdp))
            self.rows = batch_group(mesh, cfg.pure_fsdp)
            if mesh.size > 1:
                self.table = _spec_table(cfg, *self.shape)
        else:
            self.rows = getattr(_PART, "view", None)

    def heads(self) -> bool:
        """Whether attention runs each model rank's own heads."""
        return (self.tp and self.cfg.n_heads % self.m == 0
                and self.cfg.n_kv_heads % self.m == 0)

    def experts(self) -> Optional[str]:
        """How the routed experts' banks split over the model positions,
        read from their `param_specs` spec: ``"experts"`` (expert
        parallelism: `model` on the expert dim), ``"ffn"`` (tensor
        parallelism inside every expert: `model` on d_ff), or None (whole
        on every position)."""
        if not self.tp or self.cfg.moe is None:
            return None
        from repro_torch.runtime import sharding
        for path, spec in _spec_table(self.cfg, *self.shape).items():
            if path[-2:] == ("moe", "w_gate"):
                if sharding._bank_dim(path, spec) is not None:
                    return "experts"
                return "ffn" if "model" in spec else None
        return None

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
        name, parent = path[-1], (path[-2] if len(path) > 1 else "")
        if parent == "attn" and name in _ATTN:
            return self.heads()
        if parent in ("mlp", "shared", "moe") and name in _MLP:
            return True
        if path == ("embed",):
            return spec[0] == "model"
        if path == ("lm_head",):
            return spec[1] == "model"
        return False

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


def _batch_axes(mesh, pure_fsdp: bool) -> Tuple[str, ...]:
    """The axes of more than one position that carry a model step's
    batch: (pod, data), and `model` too under `pure_fsdp`."""
    names = ("pod", "data", "model") if pure_fsdp else ("pod", "data")
    return tuple(a for a in names if mesh.shape.get(a, 1) > 1)


def batch_group(mesh, pure_fsdp: bool = False):
    """On a rank mesh, the process group of the ranks that hold the other
    batch rows of this one's model step (`_batch_axes`); None off a rank
    mesh, or where no batch axis has more than one position."""
    from repro_torch.launch.mesh import RankMesh
    if not isinstance(mesh, RankMesh):
        return None
    axes = _batch_axes(mesh, pure_fsdp)
    return mesh.axes_group(axes) if axes else None


def global_rows(x: torch.Tensor, group, dim: int = -3) -> torch.Tensor:
    """The global batch of which this rank holds the block `x` along
    `dim`: every rank's block of `group` (`batch_group`) joined in rank
    order, the reference's row order; its gradient is the sum of every
    rank's cotangent of this rank's rows. `x` itself where `group` is
    None (one batch rank); `witness_parts`' join on its threads."""
    if group is None:
        return x
    if isinstance(group, _Part):
        return group.join(x, dim)
    return _GatherRows.apply(x, dim, group)


def gather_blocks(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of `group` all-gathered along `dim`, for a whole
    that every rank then uses alike: the backward keeps this rank's block
    of the cotangent, the same on every rank."""
    return _GatherLeaf.apply(x, dim, group, False)


def own_rows(x: torch.Tensor, group, dim: int = -3) -> torch.Tensor:
    """The inverse of `global_rows`: this rank's block of the global
    rows `x` along `dim`, whose cotangent the other rows do not see."""
    if group is None:
        return x
    if isinstance(group, _Part):
        return group.own(x, dim)
    return _OwnRows.apply(x, dim, group)


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
