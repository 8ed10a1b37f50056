"""Sharding rules and sharded event execution, the port of
`repro.runtime.sharding`.

Spec rules (`repro`'s policy, rule for rule): tensor parallelism over
`model` (vocab, d_ff, flattened head dims, experts: expert parallelism
when the expert count divides the axis, else TP inside the experts);
batch over (`pod`, `data`), as many of those axes as divide B; FSDP
(`cfg.fsdp`) shards the non-TP matrix dim over `data` too; KV caches shard
kv-heads over `model` when they divide, else the sequence; SDSA statuses
shard heads; stacked block params get a leading None. A spec is a
`PartitionSpec`: a tuple with one entry per dim, each an axis name, a
tuple of axis names, or None.

`named` and `replicated` return placement descriptors that record a spec
against a mesh. On a rank mesh (`launch.mesh.RankMesh`) every spec is
placed: `local_params` keeps each rank's shard of every leaf, the one
JAX's `NamedSharding` puts on the same mesh position (tensor-parallel
`model` dims, FSDP `data` dims, pure FSDP's whole-mesh dims, the expert
banks); `full_leaves` gathers the full tree back and `leaf_cuts` cuts it
again, one leaf at a time, as a checkpoint is written and read. The
products and collectives that run on those shards are
`models.placement`'s.
What runs per shard on a one-process mesh is the event execution:
`event_op_sharded` splits a matmul-form op's rows over the
batch-parallel axes and launches the resolved kernel once per shard, on
that shard's slice and work list.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm import _tree_map

TILE = 128


class PartitionSpec(tuple):
    """One entry per dim: an axis name, a tuple of axis names, or None. A
    one-name tuple is stored as the name, as `jax.sharding.PartitionSpec`
    stores it, so specs compare equal to the reference's as tuples."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec recorded against a mesh (`local_params` places a tree by the
    specs on a rank mesh; see the module doc)."""
    mesh: Mesh
    spec: PartitionSpec


# ------------------------------------------------------------ mesh helpers
def model_size(mesh: Mesh) -> int:
    return mesh.shape["model"]


def batch_axes(mesh: Mesh, b: int, include_model: bool = False
               ) -> Tuple[str, ...]:
    """Largest prefix of ('pod', 'data'[, 'model']) whose product divides
    b. include_model=True is the pure-FSDP regime (the whole mesh
    data-parallel)."""
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    out, prod = [], 1
    for a in (a for a in names if a in mesh.shape):
        if b % (prod * mesh.shape[a]) == 0:
            out.append(a)
            prod *= mesh.shape[a]
    return tuple(out)


def _bspec(mesh: Mesh, b: int):
    ax = batch_axes(mesh, b)
    return ax if ax else None


# ------------------------------------------------------------ param specs
_COL_NAMES = {"w_q", "w_k", "w_v", "w_gate", "w_up", "in_proj", "dt_proj",
              "frontend_proj", "w_i", "w_f", "w_z", "lm_head"}
_ROW_NAMES = {"w_o", "w_down", "out_proj", "x_proj", "w_out"}


def tp_axes(cfg: LMConfig, mesh: Mesh) -> Tuple[str, ...]:
    """Tensor-parallel axes: ('model',), or (data, model) for the tp2d
    serving regime."""
    if getattr(cfg, "tp2d", False):
        return tuple(a for a in ("data", "model") if a in mesh.shape)
    return ("model",)


def _param_rule(path: Tuple[str, ...], shape: Tuple[int, ...],
                cfg: LMConfig, mesh: Mesh) -> PartitionSpec:
    tp = tp_axes(cfg, mesh)
    m = math.prod(mesh.shape[a] for a in tp)
    tp_spec = tp if len(tp) > 1 else tp[0]
    fsdp = "data" if (cfg.fsdp and "data" in mesh.shape
                      and not getattr(cfg, "tp2d", False)) else None
    name = path[-1]
    in_blocks = "blocks" in path

    def wrap(*spec):
        return P(None, *spec) if in_blocks else P(*spec)

    core = shape[1:] if in_blocks else shape
    m1 = model_size(mesh)

    if getattr(cfg, "pure_fsdp", False):
        # ZeRO-3: no TP; one (the largest divisible) dim of every matrix
        # over the whole (data x model) mesh, for storage.
        axes_all = tuple(a for a in ("data", "model") if a in mesh.shape)
        n_all = math.prod(mesh.shape[a] for a in axes_all)
        if len(core) >= 2:
            order = sorted(range(len(core)), key=lambda i: -core[i])
            for nshards, ax in ((n_all, axes_all), (m1, "model")):
                for i in order:
                    if core[i] % nshards == 0:
                        return wrap(*[ax if j == i else None
                                      for j in range(len(core))])
        return wrap(*([None] * len(core)))

    def tp_for(dim: int):
        """Largest of (2-D tp axes, model only, nothing) dividing `dim`."""
        if dim % m == 0:
            return tp_spec
        if dim % m1 == 0:
            return "model"
        return None

    if name == "embed":
        v_ax = tp_for(shape[0])
        if v_ax is not None:
            return P(v_ax, fsdp)
        return P(None, tp_for(shape[1]) or fsdp)
    if name == "lm_head":
        v_ax = tp_for(shape[1])
        if v_ax is not None:
            return P(fsdp, v_ax)
        return P(tp_for(shape[0]) or fsdp, None)
    if name in ("r_i", "r_f", "r_z", "r_o"):
        return wrap(*([None] * len(core)))
    if len(core) == 3 and name in ("w_gate", "w_up", "w_down"):
        e_ax = tp_for(core[0])
        if e_ax is not None:                         # expert parallelism
            return wrap(e_ax, fsdp, None) if name != "w_down" \
                else wrap(e_ax, None, fsdp)
        if name == "w_down":                         # TP inside experts
            return wrap(None, tp_for(core[1]), fsdp)
        return wrap(None, fsdp, tp_for(core[2]))
    if name in ("w_i", "w_f") and len(core) == 2 and core[1] <= 128:
        return wrap(None, None)                      # mLSTM gate vectors
    if name in _COL_NAMES and len(core) == 2:
        ax = tp_for(core[1])
        return wrap(fsdp, None) if ax is None else wrap(fsdp, ax)
    if name in _ROW_NAMES and len(core) == 2:
        ax = tp_for(core[0])
        return wrap(None, fsdp) if ax is None else wrap(ax, fsdp)
    if name == "conv_w":
        return wrap(None, tp_for(core[1]))
    if name == "a_log":
        return wrap(tp_for(core[0]), None)
    if name == "d_skip":
        return wrap(tp_for(core[0]))
    return wrap(*([None] * len(core)))              # norms, router, ...


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """`fn(path, leaf)` over the tensor leaves of a dict / list / tuple /
    NamedTuple tree; the path holds dict keys, list indices (as strings)
    and NamedTuple field names."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _spec_leaves(tree, path: Tuple[str, ...] = ()):
    """(path, spec) of a spec tree, specs as leaves."""
    if tree is None:
        return
    if isinstance(tree, (PartitionSpec, NamedSharding)):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _spec_leaves(v, path + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (str(i),))


def param_specs(cfg: LMConfig, abstract_params: Any, mesh: Mesh) -> Any:
    """A `PartitionSpec` tree matching the param tree (its leaves may be
    `meta` tensors: `models.lm.abstract_params`)."""
    def rule(path, leaf):
        rule_path = tuple(x for x in path if not x.isdigit())
        return _param_rule(rule_path or ("param",), tuple(leaf.shape),
                           cfg, mesh)
    return _map_with_path(rule, abstract_params)


# ------------------------------------------------------------- batch specs
def batch_specs(cfg: LMConfig, batch: Dict[str, Any], mesh: Mesh) -> Dict:
    out = {}
    include_model = getattr(cfg, "pure_fsdp", False)
    for k, v in batch.items():
        bs = batch_axes(mesh, v.shape[0], include_model=include_model) \
            or None
        out[k] = P(bs, *([None] * (v.dim() - 1)))
    return out


# ------------------------------------------------------------- state specs
def decode_state_specs(cfg: LMConfig, state: Any, mesh: Mesh) -> Any:
    """Specs for the decode state (a list of `models.lm.LayerState`), built
    from the LayerState fields, as `repro` builds them."""
    from repro_torch.models.lm import LayerState
    m = model_size(mesh)
    tp2d = getattr(cfg, "tp2d", False)
    tp = tp_axes(cfg, mesh)
    m2 = math.prod(mesh.shape[a] for a in tp)

    def kv_cache_spec(x):            # (G, B, S, KV, dh)
        _, b, s_len, kv, _ = x.shape
        if tp2d:
            if s_len % m2 == 0:
                return P(None, None, tp if len(tp) > 1 else tp[0],
                         None, None)
            return P(None, None, "model" if s_len % m == 0 else None,
                     None, None)
        bs = _bspec(mesh, b)
        if kv % m == 0:
            return P(None, bs, None, "model", None)
        if s_len % m == 0:
            return P(None, bs, "model", None, None)
        return P(None, bs, None, None, None)

    def bs_of(b):
        return None if tp2d else _bspec(mesh, b)

    def status_spec(x):              # (G, B, H, dh)
        _, b, h, _ = x.shape
        return P(None, bs_of(b), "model" if h % m == 0 else None, None)

    def dim2_model_spec(x):
        rest = [None] * (x.dim() - 3)
        d2 = "model" if x.shape[2] % m == 0 else None
        return P(None, bs_of(x.shape[1]), d2, *rest)

    def dim3_model_spec(x):
        mid = [None] * (x.dim() - 3)
        dl = "model" if x.shape[-1] % m == 0 else None
        return P(None, bs_of(x.shape[1]), *mid, dl)

    def batch_only_spec(x):
        return P(None, bs_of(x.shape[1]), *([None] * (x.dim() - 2)))

    def one(st):
        mamba = None
        if st.mamba is not None:
            mamba = type(st.mamba)(h=dim2_model_spec(st.mamba.h),
                                   conv=dim3_model_spec(st.mamba.conv))
        return LayerState(
            kv=_tree_map(kv_cache_spec, st.kv),
            sdsa=_tree_map(status_spec, st.sdsa),
            mamba=mamba,
            mlstm=_tree_map(batch_only_spec, st.mlstm),
            slstm=_tree_map(dim2_model_spec, st.slstm),
            cross_kv=_tree_map(kv_cache_spec, st.cross_kv),
            cross_status=_tree_map(status_spec, st.cross_status))

    return [one(st) for st in state]


# ---------------------------------------------------------------- helpers
def named(mesh: Mesh, spec_tree: Any) -> Any:
    """The spec tree as `NamedSharding` descriptors on `mesh` (records;
    `local_params` places by the specs themselves)."""
    if isinstance(spec_tree, PartitionSpec):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(named(mesh, v) for v in spec_tree))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(named(mesh, v) for v in spec_tree)
    return spec_tree


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def validate_specs(abstract_tree: Any, spec_tree: Any, mesh: Mesh) -> list:
    """Every sharded dim must be splittable (uneven shards are padded, so
    only a dim smaller than its shard count is fatal): the list of
    (path, shape, dim, axes, shards) problems."""
    leaves = []
    _map_with_path(lambda p, x: leaves.append((p, x)), abstract_tree)
    problems = []
    for (path, leaf), (_, spec) in zip(leaves, _spec_leaves(spec_tree)):
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            size = math.prod(mesh.shape[a] for a in axes)
            if leaf.shape[dim] < size:
                problems.append((path, tuple(leaf.shape), dim, ax, size))
    return problems


# ------------------------------------------------ leaves on a rank mesh
EXPERT_BANKS = ("w_gate", "w_up", "w_down")


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry: () for None."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def splits(spec, mesh) -> list:
    """(dim, axes, shards) of every dim that `spec` splits over more than
    one position of `mesh`; the axes of a dim must come in mesh order (a
    shard's index is row-major over them, as JAX lays it out)."""
    out = []
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        k = math.prod(mesh.shape[a] for a in axes)
        if k > 1:
            if list(axes) != [a for a in mesh.axis_names if a in axes]:
                raise ValueError(f"spec {spec}: axes {axes} are not in the "
                                 f"mesh's order {mesh.axis_names}")
            out.append((dim, axes, k))
    return out


def shard_index(mesh, axes: Tuple[str, ...], rank: Optional[int] = None
                ) -> int:
    """Rank `rank`'s shard index along a dim split over `axes`: its
    coordinates row-major over them."""
    c = mesh.coords(rank)
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + c[a]
    return i


def split_axes(spec, mesh) -> frozenset:
    """The mesh axes (of more than one position) that `spec` splits a leaf
    over."""
    return frozenset(a for _, axes, _ in splits(spec, mesh) for a in axes
                     if mesh.shape[a] > 1)


def _bank_dim(path: Tuple[str, ...], spec) -> Optional[int]:
    """The expert dim of an MoE expert bank that `spec` puts on `model`
    alone (expert parallelism), else None."""
    if len(path) < 2 or path[-1] not in EXPERT_BANKS or path[-2] != "moe":
        return None                     # (a shared expert's MLP is not)
    dim = 1 if "blocks" in path else 0
    return dim if len(spec) > dim and spec[dim] == "model" else None


def _zip_specs(fn, tree, specs, path: Tuple[str, ...] = ()):
    """`fn(path, leaf, spec)` over a tree and its matching spec tree (a
    `PartitionSpec` is a leaf of the spec tree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k], path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_specs(fn, v, sp, path + (f,))
                            for f, v, sp in zip(tree._fields, tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_specs(fn, v, sp, path + (str(i),))
                          for i, (v, sp) in enumerate(zip(tree, specs)))
    return fn(path, tree, specs)


def state_specs(param_spec_tree: Any) -> Any:
    """The specs of a (params, `AdamWState`) training state: the moments
    as their params, the step replicated."""
    from repro_torch.optim.adamw import AdamWState
    return (param_spec_tree, AdamWState(step=P(), mu=param_spec_tree,
                                        nu=param_spec_tree))


def _cut_of(path: Tuple[str, ...], spec, mesh, rank: Optional[int] = None):
    """The function that cuts the whole leaf at `path` to rank `rank`'s
    shard of it by `spec` (a contiguous copy), or None for a leaf that
    no axis of more than one position splits. A dim its shard count does
    not divide raises, as JAX refuses such a placement."""
    cuts = splits(spec, mesh)
    if not cuts:
        return None
    idx = [(dim, k, shard_index(mesh, axes, rank)) for dim, axes, k in cuts]

    def cut(leaf: torch.Tensor) -> torch.Tensor:
        for dim, k, i in idx:
            n = leaf.shape[dim]
            if n % k:
                raise ValueError(
                    f"{'.'.join(path)}: dim {dim} of {tuple(leaf.shape)} "
                    f"does not split into {k} shards ({spec})")
            leaf = leaf.narrow(dim, i * (n // k), n // k)
        return leaf.clone(memory_format=torch.contiguous_format)
    return cut


def local_params(tree: Any, specs: Any, mesh, rank: Optional[int] = None
                 ) -> Any:
    """Rank `rank`'s part of `tree` (params, or any tree of their shape
    such as a training state with `state_specs`, or a decode state with
    `decode_state_specs`) on a rank mesh: every leaf cut by its spec, the
    shard JAX's `NamedSharding` places on the same mesh position (a
    dim's shard index row-major over its axes; the tensor-parallel
    `model` dims, the FSDP `data` dims, pure FSDP's (data, model) dims
    and the expert banks alike). Each cut leaf is a contiguous copy, so
    the whole leaf can be freed; a leaf no axis splits is kept as it is
    (replicated)."""
    def one(path, leaf, spec):
        cut = _cut_of(path, spec, mesh, rank)
        return leaf if cut is None else cut(leaf)
    return _zip_specs(one, tree, specs)


def local_init(cfg: LMConfig, seed: int, mesh, device="cuda") -> Any:
    """This rank's `local_params` of `lm.init_params(cfg, seed, device)`
    on the rank mesh `mesh`, bit for bit, with each leaf cut as it is
    drawn: the rank holds its own part of the tree and one whole layer
    beside it, never the whole tree."""
    from repro_torch.models import lm
    table = dict(_spec_leaves(param_specs(cfg, lm.abstract_params(cfg),
                                          mesh)))

    def cut(prefix, tree, layer):
        def one(path, leaf):
            full = prefix + path
            spec = table[full][1:] if layer else table[full]
            fn = _cut_of(full, spec, mesh)
            return leaf if fn is None else fn(leaf)
        return _map_with_path(one, tree)
    return lm.init_params(cfg, seed, device, cut=cut)


def leaf_cuts(tree: Any, specs: Any, mesh) -> list:
    """Per leaf of the whole tree `tree`, in `optim.adamw.leaves` order
    (a checkpoint's): the function that cuts it to this rank's
    `local_params` part, or None where the leaf is replicated. A restore
    applies each as its leaf is read, so no whole leaf of a split kind
    reaches the device."""
    from repro_torch.optim.adamw import leaves
    return leaves(_zip_specs(lambda path, leaf, spec: _cut_of(path, spec,
                                                              mesh),
                             tree, specs))


def leaf_split_axes(tree: Any, specs: Any, mesh) -> list:
    """Per leaf of `tree`, in `optim.adamw.leaves` order: the axes its
    `local_params` part is split over (empty where it is replicated)."""
    from repro_torch.optim.adamw import leaves
    return leaves(_zip_specs(lambda path, leaf, spec: split_axes(spec, mesh),
                             tree, specs))


def sliced_leaves(tree: Any, specs: Any, mesh) -> list:
    """Per leaf of `tree`, in `optim.adamw.leaves` order (dict keys
    sorted): whether `local_params` cuts it on `mesh`."""
    return [bool(a) for a in leaf_split_axes(tree, specs, mesh)]


def _whole(path: Tuple[str, ...], leaf: torch.Tensor, spec, mesh
           ) -> torch.Tensor:
    """`leaf`, this rank's `local_params` part, gathered whole: each split
    dim in turn along the group of its axes (`distributed.all_gather`);
    a replicated leaf as it is."""
    from repro_torch.launch import distributed
    for dim, axes, _ in splits(spec, mesh):
        leaf = distributed.all_gather(leaf, dim, mesh.axes_group(axes))
    return leaf


def full_leaves(tree: Any, specs: Any, mesh):
    """The inverse of `local_params` on the rank mesh `mesh`, one leaf at
    a time in `optim.adamw.leaves` order (a checkpoint's): each cut leaf
    gathered whole over the ranks of its axes when it is reached, every
    other leaf as it is. A rank holds one whole leaf beyond its own part
    at a time. Every rank of the mesh walks it to its end, in the same
    order."""
    from repro_torch.optim.adamw import leaves
    for gather in leaves(_zip_specs(
            lambda path, leaf, spec: functools.partial(_whole, path, leaf,
                                                       spec, mesh),
            tree, specs)):
        yield gather()


# ----------------------------------------------- event ops under the mesh
def event_rows_axes(mesh: Mesh, rows: int) -> Tuple[str, ...]:
    """The mesh axes the event-row axis shards over: the batch-parallel
    ('pod', 'data') prefix that divides the row count; `model` shards
    features and heads, never event rows."""
    return batch_axes(mesh, rows)


def _shard_counts(s: torch.Tensor, n_shards: int,
                  packed_k: Optional[int]) -> torch.Tensor:
    """Per-shard occupied-tile counts on s's device (int64, one per
    shard): the spike rows split as `np.array_split` splits them, each
    shard's own padded (128, 128) pre-pass (word popcounts for packed
    words, the same counts)."""
    from repro_torch.core.spikes import (ragged_packed_tile_occupancy,
                                         ragged_tile_occupancy)
    s2 = s.reshape(-1, s.shape[-1])
    count = ragged_packed_tile_occupancy if packed_k is not None \
        else ragged_tile_occupancy
    return torch.stack([(count(chunk, TILE, TILE) > 0).sum()
                        for chunk in torch.tensor_split(s2, n_shards)])


def per_shard_occupied_tiles(s: torch.Tensor, n_shards: int, *,
                             packed_k: Optional[int] = None) -> list:
    """Occupied-tile count each row shard of `s` owns: the event-load
    signal `runtime.straggler.occupancy_imbalance` summarizes. Splits the
    SPIKE rows (flattened lead axes, contiguous chunks, what each shard is
    handed) and runs each shard's own padded pre-pass; splitting the
    global map's tile rows instead would misattribute load wherever a
    shard's rows are not a multiple of 128. `packed_k` marks `s` as
    uint32 words (counts from popcounts). One host read of the counts."""
    return [int(c) for c in _shard_counts(s, n_shards, packed_k).tolist()]


# Backends whose kernels consume a pre-built per-shard `TileCSR`: the
# event-compacted families of each payload (`repro`'s pallas-csr and
# packed-csr families).
_CSR_FAMILY = {"dense": ("cuda", "cuda-pipe"),
               "packed": ("cuda-packed", "cuda-packed-pipe")}
_PIPELINED = ("cuda-pipe", "cuda-packed-pipe")


class _ShardedMatmul(torch.autograd.Function):
    """Runs the per-shard forward with autograd off; the backward is the
    matmul rule of the pinned backends (`dispatch._matmul_bwd`), per
    shard on that shard's operands: ds is the shards' cotangents in
    order, dw the sum of the shards'."""

    @staticmethod
    def forward(ctx, run, static, n_shards, s, w):
        ctx.static, ctx.n = static, n_shards
        ctx.save_for_backward(s, w)
        return run(s, w)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.dispatch import _matmul_bwd
        s, w = ctx.saved_tensors
        ds, dw = [], None
        for s_i, g_i in zip(torch.tensor_split(s.reshape(-1, s.shape[-1]),
                                               ctx.n),
                            torch.tensor_split(g.reshape(-1, g.shape[-1]),
                                               ctx.n)):
            ds_i, dw_i = _matmul_bwd((s_i, w), ctx.static, g_i)
            ds.append(ds_i)
            dw = dw_i if dw is None else dw + dw_i
        ds_all = None
        if ctx.needs_input_grad[3] and ds[0] is not None:
            ds_all = torch.cat(ds).reshape(s.shape)
        return None, None, None, ds_all, \
            dw if ctx.needs_input_grad[4] else None


def _upload(host: list, device: torch.device) -> list:
    """Host int32 arrays on `device` in ONE transfer: packed into one
    pinned buffer, copied without a host sync, split into views there.
    (A copy per array would cost a synchronizing copy from pageable
    memory each: 40 work-list fields at 8 shards.) On the CPU, as they
    are."""
    host = [torch.as_tensor(h).to(torch.int32) for h in host]
    if device.type == "cpu" or not host:
        return host
    flat = torch.cat([h.reshape(-1) for h in host]).pin_memory()
    flat = flat.to(device, non_blocking=True)
    out, at = [], 0
    for h in host:
        out.append(flat[at:at + h.numel()].view(h.shape))
        at += h.numel()
    return out


def _permute_tile_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x's 128-row tile rows in `index` order (uint32 words move as their
    int32 view)."""
    words = x.dtype == torch.uint32
    y = x.view(torch.int32) if words else x
    y = y.reshape((index.shape[0], -1) + tuple(y.shape[1:])) \
        .index_select(0, index).reshape(y.shape)
    return y.view(torch.uint32) if words else y


def _csr_stack_map(stack, n_shards: int) -> torch.Tensor:
    """The (MT, KT) map a stacked per-shard work list names: each shard's
    listed tiles with their event counts (dummy and padding steps add 0),
    the shards' local maps stacked in shard order. Built where the lists
    lie, with no host read: a tile no list names is claimed empty, so the
    guard audits exactly what the kernels would trust."""
    from repro_torch.core.spikes import unstack_shard_csrs
    csrs = unstack_shard_csrs(stack)
    if len(csrs) != n_shards:
        raise ValueError(f"csr_stack holds {len(csrs)} shards, the mesh "
                         f"splits {n_shards}")
    if stack.map_shape is None:
        raise ValueError("csr_stack carries no map_shape to audit against")
    mt, kt = (int(x) for x in stack.map_shape)
    maps = []
    for c in csrs:
        m = torch.zeros(mt * kt, dtype=torch.int32, device=c.occ.device)
        m.index_add_(0, (c.tile_m_idx.long() * kt + c.tile_k_idx.long()),
                     (c.occ * c.valid).to(torch.int32))
        maps.append(m.view(mt, kt))
    return torch.cat(maps)


def _gathered_map(occ: torch.Tensor, group) -> torch.Tensor:
    """The ranks' maps of `group` joined in shard order, on the host: one
    all-gather where the map lies (the control device for a map on the
    host), then one read of a map on the card."""
    from repro_torch.launch import distributed
    dev = occ.device if occ.device.type != "cpu" \
        else distributed.control_device()
    return distributed.all_gather(occ.to(dev), 0, group).cpu()


def _moved_rows(plan) -> int:
    """Tile rows the plan hands to a shard other than the one that owns
    them under the static split."""
    perm = torch.as_tensor(plan.perm, dtype=torch.int64)
    rps = len(perm) // plan.n_shards
    return int((perm // rps != torch.arange(len(perm)) // rps).sum())


def _route_tiles(x: torch.Tensor, plan, me: int, group,
                 back: bool = False) -> torch.Tensor:
    """A rank's tile rows moved by `plan` over `group` (`me` its shard):
    `x` holds one entry a tile row (a 128-row block of spikes or outputs,
    or a row of the map). Forward, the rank's own tile rows in, the tile
    rows its shard computes out (in the plan's order); `back`, the
    computed ones in, its own out. Only the rows the plan moves cross
    between ranks (`distributed.exchange`)."""
    from repro_torch.launch import distributed
    n = plan.n_shards
    rps = len(plan.perm) // n
    perm = torch.as_tensor(plan.perm, dtype=torch.int64)
    owner = (perm // rps).view(n, rps)       # [shard, slot] -> owner
    slot = (perm % rps).view(n, rps)         # [shard, slot] -> its row there
    unit = tuple(x.shape[1:])
    home, kind = x.device, x.dtype
    if kind == torch.uint32:   # words move (and are indexed) as int32
        x = x.view(torch.int32)
    if home.type == "cpu":     # a map on the host: NCCL moves card memory
        x = x.to(distributed.control_device())
    dev = x.device
    mine = [(owner[d] == me) for d in range(n)]     # my rows shard d takes
    computed_from = [owner[me] == o for o in range(n)]
    if not back:
        sends = [x[slot[d][mine[d]].to(dev)] for d in range(n)]
        shapes = [[(int((owner[d] == r).sum()),) + unit for d in range(n)]
                  for r in range(n)]
        recv = distributed.exchange(sends, shapes, group)
        out = x.new_empty(x.shape)
        for o in range(n):
            out[computed_from[o].to(dev)] = recv[o]
        return out.to(home).view(kind)
    sends = [x[computed_from[o].to(dev)] for o in range(n)]
    shapes = [[(int((owner[r] == o).sum()),) + unit for o in range(n)]
              for r in range(n)]
    recv = distributed.exchange(sends, shapes, group)
    out = x.new_empty(x.shape)
    for d in range(n):
        out[slot[d][mine[d]].to(dev)] = recv[d]
    return out.to(home).view(kind)


def event_op_sharded(mesh: Mesh, op: str, s, w, *, csr_stack=None,
                     occupancy=None, with_report: bool = False,
                     rebalance: Optional[bool] = None, **kwargs):
    """Run a matmul-form registry op (`spike_matmul` / `apec_matmul`) per
    data shard of `mesh`, with mesh-aware resolution.

    The event rows (leading axis of `s`) split over the batch-parallel
    mesh axes into contiguous equal slices (`launch.mesh.shard_map`); `w`
    is replicated. Resolution runs once, against the per-shard shapes
    (`dispatch.resolve(..., mesh=)`: an event-compacted family holds while
    each shard's tile grid fills whole 128-row tiles, else it walks its
    declared chain, attributed ``<chosen><-<requested>``). The resolved
    kernel then launches once per shard, on that shard's slice and work
    list; no shard is stitched into a global launch.

    On a rank mesh (`launch.mesh.RankMesh`) a shard is a rank: each rank
    passes its own rows of `s` (every batch axis, `pod` then `data`,
    splits the rows; ranks along `model` hold the same rows and compute
    the same output) and its own slice of what comes with them: its rows
    of the carried map, its own entry of a `csr_stack` (stacked or not),
    or an `EventTensor` of its rows. It resolves as the one-process call
    on the whole rows would, launches the resolved kernel once on its own
    rows on `mesh.device`, and returns its own output rows. A map on the
    host is all-gathered over the batch ranks (it is small), so each
    rank's work list is the one-process call's list of its shard.

    `s` may be an `EventTensor` (or `occupancy=` a carried map). A carried
    map on the host compacts straight into per-shard trimmed work lists
    (`core.spikes.shard_occupancy_to_csr` on the small map; no dense
    pre-pass, no read of the spikes). A map on the card is never read on
    the host unless the caller asks for rebalancing (``rebalance=True``):
    its row slices go to the shards, each compacting its own on the card.
    Where the per-shard tile grid cannot split the map (ragged rows), the
    map is dropped with a warning and the shards re-derive it.

    `csr_stack`: a stacked per-shard `TileCSR` (`shard_occupancy_to_csr` +
    `stack_shard_csrs`) for `spike_matmul` on an event-compacted family;
    each shard consumes its own list. Packed words (a packed-only
    `EventTensor`, or uint32 words with ``packed_k=``) shard the same way:
    the (128, 128) map's k-tiling is the words' tiling.

    `rebalance`: where a carried map feeds the per-shard work lists of a
    2-D payload, the split may be occupancy-weighted
    (`core.spikes.rebalance_shard_plan`): the payload's 128-row tile rows
    are permuted so each shard still owns one contiguous equal slice, and
    the outputs are permuted back, so every output row is computed as
    before, by another shard. None (the default) rebalances a map on the
    host, as `repro` rebalances a concrete one, and leaves a map on the
    card static, as `repro` leaves a traced one; True also rebalances a
    map on the card, which costs one host read of it a call (the report's
    `host_reads`: a sync); False never rebalances. Shards of one 128-row
    tile row each cannot be balanced better, so they are never planned
    (and nothing is read). As in `repro`, only `spike_matmul`'s work-list
    route rebalances. On ranks the plan comes from the all-gathered map,
    and only the tile rows it moves cross between ranks: each goes to the
    rank that computes it and its output back to the rank that owns it
    (`distributed.exchange`).

    Under `dispatch.use_guard("audit" | "repair")` every shard runs the
    guarded backend on its own slice of the map (a `csr_stack` as the map
    its lists name, `_csr_stack_map`), so a sharded call is audited or
    repaired as the unsharded one is: a map on the host raises or repairs
    on the host's read, one on the card poisons or repairs on the card.
    The host-built work lists are not used then (each shard's backend
    compacts its own slice); rebalancing moves the map with the rows.

    Differentiable: a `torch.autograd.Function` whose backward is the
    matmul rule of the pinned backends, per shard. On a rank mesh `ds` is
    the rank's own rows' and `dw` the rank's partial, from its own rows,
    as for every rank-local op of the port: the train step's batch sum
    adds the partials.

    `with_report=True` also returns the routing report: backend,
    attribution, `n_shards`, `occupancy_source` (carried / csr_stack /
    rederived), `host_reads` of the map, `moved_bytes` (the bytes of the
    tile rows a plan hands to another shard and of their outputs sent
    back: on ranks what crosses between them; 0 without a plan), and
    `occupancy`, the per-shard occupied-tile `OccupancyImbalance` (the
    plan's pre / post counts when rebalanced, else each shard's own
    pre-pass of its spikes, one host read of the counts; on ranks one
    all-gather of each rank's count) with each shard's hybrid route under
    hybrid. Every rank gets the same report, the one-process call's.
    """
    from repro_torch.core.events import EventTensor
    from repro_torch.core.spikes import (CSR_FIELDS, TileCSR,
                                         rebalance_shard_plan,
                                         shard_occupancy_to_csr,
                                         stack_shard_csrs,
                                         unstack_shard_csrs)
    from repro_torch.kernels import dispatch, ops
    from repro_torch.launch.mesh import RankMesh, shard_map

    if op not in ("spike_matmul", "apec_matmul"):
        raise ValueError(f"event_op_sharded runs the matmul-form ops "
                         f"spike_matmul / apec_matmul, not {op!r}")
    if isinstance(s, EventTensor):
        if occupancy is None:
            occupancy = s.occupancy_for(TILE, TILE)
        if s.is_packed:
            kwargs = dict(kwargs, packed_k=s.feature_size)
            s = s.packed
        else:
            s = s.spikes
    packed_k = kwargs.get("packed_k")

    ranked = isinstance(mesh, RankMesh)
    # On ranks every batch axis splits the rows: each holds its own.
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape) if ranked \
        else event_rows_axes(mesh, s.shape[0])
    n_shards = math.prod(mesh.shape[a] for a in axes) if axes else 1
    rows = math.prod(s.shape[:-1])
    shard_rows = rows if ranked else rows // n_shards
    group = mesh.axes_group(axes) if ranked and n_shards > 1 else None
    me = shard_index(mesh, axes) if group is not None else 0
    plan = None          # set iff occupancy-weighted rebalancing engages
    host_reads = 0
    map_moves = False    # the map's rows move with a plan (guarded)

    def per_shard_routes(attribution, counts):
        """Each shard's hybrid route ("event" / "dense"), from its own
        occupied-tile count on the calibrated predicate: the decision the
        per-shard body makes, named per shard for the report."""
        from repro_torch.core import costmodel
        mt_l = -(-shard_rows // TILE)
        kt = -(-(packed_k or int(s.shape[-1])) // TILE)
        return tuple(
            "event" if costmodel.event_route_wins(
                op, costmodel.bucket_representative(
                    costmodel.pow2_bucket(c), mt_l * kt), mt_l, kt)
            else "dense" for c in counts)

    def shard_counts() -> list:
        if group is None:
            return per_shard_occupied_tiles(s, n_shards, packed_k=packed_k)
        from repro_torch.launch import distributed
        own = _shard_counts(s, 1, packed_k).to(distributed.control_device())
        return [int(c) for c in distributed.all_gather(own, 0, group)
                .tolist()]

    def report(backend, attribution, occupancy_source, out):
        if not with_report:
            return None
        from repro_torch.runtime.straggler import occupancy_imbalance
        moved = 0
        if plan is not None:
            tile_bytes = TILE * (s.shape[-1] * s.element_size()
                                 + out.shape[-1] * out.element_size())
            if map_moves:
                tile_bytes += occupancy.shape[-1] * occupancy.element_size()
            moved = _moved_rows(plan) * tile_bytes
        rep = {"op": op, "backend": backend, "attribution": attribution,
               "n_shards": n_shards, "occupancy": None,
               "occupancy_source": occupancy_source,
               "host_reads": host_reads, "moved_bytes": moved}
        if n_shards > 1:
            # Routes come from the static split's counts, as in `repro`.
            hybrid = "hybrid" in attribution
            counts = shard_counts() if plan is None or hybrid else None
            routes = per_shard_routes(attribution, counts) if hybrid else ()
            if plan is not None:
                rep["occupancy"] = occupancy_imbalance(
                    plan.post_per_shard, routes=routes,
                    pre_per_shard=plan.pre_per_shard)
            else:
                rep["occupancy"] = occupancy_imbalance(counts, routes=routes)
        return rep

    if csr_stack is not None and op != "spike_matmul":
        raise ValueError(
            f"csr_stack is a spike_matmul pass-through; op {op!r} builds "
            f"its own (union) work list in its wrapper")
    if csr_stack is not None and ranked and csr_stack.row_ptr.dim() == 1:
        csr_stack = stack_shard_csrs([csr_stack])      # the rank's own
    held = 1 if ranked else n_shards     # the shards this process runs
    stack_audited = False
    if csr_stack is not None and n_shards > 1 \
            and dispatch.guard_mode() != "off":
        # The guard audits maps: the stacked lists become the map they
        # name, and the call takes the guarded map route below.
        occupancy, csr_stack, stack_audited = \
            _csr_stack_map(csr_stack, held), None, True
    ragged = (rows % TILE) if ranked else (
        rows % n_shards or (rows // n_shards) % TILE
        or (occupancy is not None and occupancy.shape[0] % n_shards))
    if n_shards > 1 and occupancy is not None and ragged:
        # A map splits into congruent per-shard maps only where every
        # shard owns whole 128-row tiles (the CSR mesh gate's condition).
        # Dropped before resolution: hybrid routes on the map.
        warnings.warn(
            f"exspike sharding: carried occupancy dropped for {op!r} — "
            f"{rows * (n_shards // held)} rows over {n_shards} shards do "
            f"not split into whole 128-row tiles; shards re-derive locally",
            RuntimeWarning, stacklevel=2)
        occupancy = None
    on_card = occupancy is not None and dispatch._device_routed(occupancy)
    # On ranks a map on the host is gathered whole (one small all-gather):
    # the one-process call resolves, plans and builds its lists on it.
    whole_map = _gathered_map(occupancy, group) \
        if group is not None and occupancy is not None and not on_card \
        else occupancy
    res_kwargs = dict(kwargs)
    res_s = s
    if group is not None:
        # Stand-ins of the whole rows' shapes (resolution reads shapes,
        # dtypes and devices; a map on the card is not gathered for it).
        res_s = s.narrow(0, 0, 1).expand((s.shape[0] * n_shards,)
                                         + tuple(s.shape[1:]))
        if on_card:
            whole_map = occupancy.narrow(0, 0, 1).expand(
                (occupancy.shape[0] * n_shards,)
                + tuple(occupancy.shape[1:]))
    if occupancy is not None:
        res_kwargs["occupancy"] = whole_map
    be, attribution = dispatch.resolve_with_attribution(
        op, res_s, w, mesh=n_shards, **res_kwargs)
    static = {"packed_k": packed_k} if packed_k is not None else {}
    # The guard wraps `be.fn` (outermost) whenever a map is carried; the
    # per-shard work lists below would go around it.
    guarded = occupancy is not None and dispatch.guard_mode() != "off"
    if occupancy is None:
        occupancy_source = "csr_stack" if csr_stack is not None \
            else "rederived"
    else:
        occupancy_source = "csr_stack" if stack_audited else "carried"

    if n_shards <= 1:
        if occupancy is not None:
            out = be.fn(s, w, occupancy=occupancy.to(s.device), **kwargs)
        else:
            out = be.fn(s, w, **kwargs)
        return (out, report(be.name, attribution, occupancy_source, out)) \
            if with_report else out

    family = _CSR_FAMILY["packed" if packed_k is not None else "dense"]
    csrs = None
    if occupancy is not None and csr_stack is None \
            and op == "spike_matmul" and be.name in family:
        occ_host = None if on_card else whole_map
        wanted = rebalance if rebalance is not None else not on_card
        # A caller's lists keep the caller's split, audited or not.
        if wanted and not stack_audited and s.dim() == 2 \
                and occupancy.shape[0] // held > 1:
            if on_card:
                # the one read: a sync (on ranks, of the gathered map)
                occ_host = _gathered_map(occupancy, group) \
                    if group is not None else occupancy.cpu()
                host_reads += 1
            plan = rebalance_shard_plan(occ_host, n_shards)
            if plan.identity or not plan.improves:
                plan = None      # nothing to win: skip the row gathers
        if occ_host is not None and not guarded:
            csrs = shard_occupancy_to_csr(occ_host, n_shards,
                                          tiling=(TILE, TILE), plan=plan)
            occupancy = None
            if group is not None:
                csrs = csrs[me:me + 1]

    if csr_stack is not None:
        if be.name not in family:
            # Degraded off the family (mesh gate / capability): the
            # pre-built lists cannot feed the resolved kernel. Say so.
            warnings.warn(
                f"exspike sharding: csr_stack ignored — {op!r} resolved "
                f"to {be.name!r} ({attribution}), not the CSR family",
                RuntimeWarning, stacklevel=2)
            occupancy_source = "carried" if occupancy is not None \
                else "rederived"
        else:
            csrs = unstack_shard_csrs(csr_stack)
            if len(csrs) != held:
                raise ValueError(f"csr_stack holds {len(csrs)} shards, "
                                 f"the mesh splits {held} here")

    # Host-built lists and the plan's permutations go to the card in one
    # transfer.
    host = [] if csrs is None else \
        [getattr(c, f) for c in csrs for f in CSR_FIELDS
         if getattr(c, f).device.type == "cpu"]
    if plan is not None and group is None:
        host += [plan.perm, plan.inverse()]
    moved = iter(_upload(host, s.device))
    if csrs is not None:
        csrs = [c._replace(**{f: next(moved) for f in CSR_FIELDS
                              if getattr(c, f).device.type == "cpu"})
                for c in csrs]
        pipelined = be.name in _PIPELINED

        def body(i, sl, wl, local):
            local = TileCSR(*(getattr(local, f).to(sl.device)
                              for f in CSR_FIELDS),
                            local.tiling, local.map_shape)
            if packed_k is not None:
                return ops.spike_matmul_packed(sl, wl, packed_k=packed_k,
                                               csr=local, pipeline=pipelined)
            return ops.spike_matmul_csr(sl, wl, local, pipeline=pipelined)
        run = shard_map(body, mesh=mesh, axes=axes,
                        shard_args=[(c,) for c in csrs])
    elif occupancy is not None:
        # A map on the card (or guarded, or a non-spike_matmul op): its
        # row slices go to the shards with their spikes; each shard's
        # backend compacts (or gates on) its own slice, with no read of a
        # map on the card. Under the guard a host map stays on the host,
        # so the guard takes the host's semantics, as unsharded.
        occ = occupancy
        if plan is not None:
            map_moves = True
            occ = _permute_tile_rows(
                occ, torch.as_tensor(plan.perm, device=occ.device)) \
                if group is None else _route_tiles(occ, plan, me, group)

        def body_occ(i, sl, wl):
            per = occ.shape[0] // held
            local = occ[i * per:(i + 1) * per]
            if on_card or not guarded:
                local = local.to(sl.device)
            return be.fn(sl, wl, occupancy=local, **kwargs)
        run = shard_map(body_occ, mesh=mesh, axes=axes)
    else:
        def body_plain(i, sl, wl):
            return be.fn(sl, wl, **kwargs)
        run = shard_map(body_plain, mesh=mesh, axes=axes)

    if group is not None:
        # One shard here: the rank's own rows, or the tile rows a plan
        # hands it (moved in, run, outputs moved back to their owners).
        def run_rank(s_, w_):
            if plan is None:
                return run(s_, w_)
            tiles = s_.reshape((-1, TILE) + tuple(s_.shape[1:]))
            got = run(_route_tiles(tiles, plan, me, group)
                      .reshape(s_.shape), w_)
            back = _route_tiles(got.reshape((-1, TILE)
                                            + tuple(got.shape[1:])),
                                plan, me, group, back=True)
            return back.reshape(got.shape)
        out = _ShardedMatmul.apply(run_rank, static, 1, s, w)
    elif plan is not None:
        perm, inverse = moved
        s_run = _permute_tile_rows(s, perm)
        out = _ShardedMatmul.apply(run, static, n_shards, s_run, w)
        out = _permute_tile_rows(out, inverse)
    else:
        out = _ShardedMatmul.apply(run, static, n_shards, s, w)
    return (out, report(be.name, attribution, occupancy_source, out)) \
        if with_report else out
