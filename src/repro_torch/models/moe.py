"""Mixture-of-experts FFN with sort-based token dispatch, the port of
`repro.models.moe`.

Dispatch is the MaxText / megablocks sort: the top-k expert ids of each
token, a stable sort of the token slots by expert, a rank-within-expert
capacity check, and a scatter into (E, capacity, d) expert batches. The
expert products are batched GEMMs (`torch.bmm`), as the reference's
`einsum`s are plain products outside any kernel.

Spiking mode: the expert inputs are binary spikes, the router is an f32
product on them, and each expert's hidden drive re-fires through the
registry's `lif_scan` (one T = 1 fire over the whole (E, C, F) bank, the
bf16 LIF kernel on the card). Shared experts (qwen2-moe) are one wide
always-on MLP (`mlp_apply`) over the flattened tokens; as in the
reference its spiking fire then scans the token axis as its time axis.

Bit-level choices that keep the port on the reference's values:
  * top-k by a stable descending sort: on tied probabilities (a spiking
    token with no spikes has all-zero router logits) the lower expert id
    comes first, as `jax.lax.top_k` orders them;
  * the router product in f32 with TF32 off, since routing turns on the
    last bit of a logit;
  * the combine adds each token's k weighted expert outputs in rising
    expert id, one rounding per add, as the reference's scatter-add in
    sorted order does, and with no atomics, so a run repeats bit for bit.

On a rank mesh both forms compute the reference's MoE of the global
batch: each rank's rows are gathered in the reference's token order,
every rank routes all of them alike and keeps its own rows of the
output (`moe_apply`'s doc).
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.lif import LIFConfig
from . import placement
from .layers import bank_init, dense_init, lif_fire, mlp_apply, mlp_init


def moe_init(d_model: int, d_ff_expert: int, n_experts: int,
             n_shared: int = 0, dtype=torch.bfloat16, bank_size: int = 0, *,
             generator: torch.Generator, device="cuda") -> dict:
    """bank_size > n_experts pads the expert BANK with dead experts (the
    mesh-divisible count of even expert parallelism); the router stays
    n_experts wide, so a dead expert never receives a token."""
    bank = max(n_experts, bank_size)

    def expert_bank(d_in, d_out):
        return bank_init((bank,), d_in, d_out, dtype, generator=generator,
                         device=device)
    p = {
        "router": dense_init(d_model, n_experts, torch.float32,
                             generator=generator, device=device),
        "w_gate": expert_bank(d_model, d_ff_expert),
        "w_up": expert_bank(d_model, d_ff_expert),
        "w_down": expert_bank(d_ff_expert, d_model),
    }
    if n_shared:
        p["shared"] = mlp_init(d_model, n_shared * d_ff_expert, dtype,
                               generator=generator, device=device)
    return p


def capacity_of(tokens: int, top_k: int, n_experts: int,
                capacity_factor: float) -> int:
    """Slots per expert for `tokens` routed tokens: the reference's Python
    float arithmetic, rounded up to a multiple of 8, at least 8."""
    capacity = int(tokens * top_k / n_experts * capacity_factor)
    return max(8, -(-capacity // 8) * 8)


@contextlib.contextmanager
def _ieee_f32():
    """f32 matmuls at full precision (no TF32) for the block."""
    was = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(was)


class Routing(NamedTuple):
    """One dispatch group's routing, in the reference's sorted order:
    every (token, k) slot sorted stably by expert id."""
    ids: torch.Tensor        # (s, k) chosen experts, best first
    weights: torch.Tensor    # (s, k) f32 gate weights
    sort_idx: torch.Tensor   # (s*k,) flat slot index of each sorted slot
    tok_idx: torch.Tensor    # (s*k,) its token
    dest: torch.Tensor       # (s*k,) its row of the bank buffer (sink if dropped)
    keep: torch.Tensor       # (s*k,) bool: within its expert's capacity


def route(router: torch.Tensor, xl: torch.Tensor, *, top_k: int,
          capacity: int, e_bank: int,
          normalize_weights: bool = True) -> Routing:
    """Top-k routing of the tokens xl (s, d) and their rank-within-expert
    capacity check. A dropped slot's `dest` is the sink row
    ``e_bank * capacity`` past the buffer (`_shard` keeps one model
    position's experts of it)."""
    e = router.shape[-1]
    with _ieee_f32():
        logits = xl.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = top.values[:, :top_k], top.indices[:, :top_k]
    if normalize_weights:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    flat_ids = ids.reshape(-1)
    sort_idx = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[sort_idx]
    starts = torch.searchsorted(
        sorted_ids, torch.arange(e, device=xl.device, dtype=sorted_ids.dtype))
    rank = torch.arange(sorted_ids.numel(), device=xl.device) \
        - starts[sorted_ids]
    keep = rank < capacity
    dest = torch.where(keep, sorted_ids * capacity + rank,
                       torch.full_like(rank, e_bank * capacity))
    return Routing(ids, weights, sort_idx, sort_idx // top_k, dest, keep)


def _dispatch(xl: torch.Tensor, r: Routing, e_bank: int,
              capacity: int) -> torch.Tensor:
    """Scatter each kept slot's token into its (expert, rank) row:
    (e_bank, capacity, d). Every dropped slot writes the sink row, which
    is cut off, so which of those duplicate writes lands never matters."""
    d = xl.shape[-1]
    gathered = xl[r.tok_idx] * r.keep[:, None].to(xl.dtype)
    buf = xl.new_zeros((e_bank * capacity + 1, d))
    buf[r.dest] = gathered
    return buf[:e_bank * capacity].reshape(e_bank, capacity, d)


def _combine(eo: torch.Tensor, r: Routing, s_loc: int,
             top_k: int) -> torch.Tensor:
    """The tokens' outputs (s_loc, d) from one group's expert outputs
    (e_bank, capacity, d): each token's k weighted slots (a dropped one
    zero) summed in sorted order, that is by rising expert id, one
    rounding in eo's dtype per add, as the reference's scatter-add in
    sorted order sums them. A gather and k adds: no atomics."""
    flat = eo.reshape(-1, eo.shape[-1])
    rows = torch.clamp(r.dest, max=flat.shape[0] - 1)
    out_sorted = flat[rows] * r.keep[:, None].to(flat.dtype)
    w_sorted = r.weights.reshape(-1)[r.sort_idx].to(flat.dtype)
    contrib = out_sorted * w_sorted[:, None]
    # The sorted positions of token t's k slots, in sorted (expert) order.
    pos = torch.empty_like(r.sort_idx)
    pos[r.sort_idx] = torch.arange(pos.numel(), device=pos.device)
    pos = pos.reshape(s_loc, top_k).sort(dim=-1).values
    acc = torch.zeros_like(contrib[:s_loc])
    for j in range(top_k):
        acc = acc + contrib[pos[:, j]]
    return acc


def _shard(r: Routing, j: int, e_loc: int, capacity: int) -> Routing:
    """`r` (a routing over the whole bank) kept to experts ``[j * e_loc,
    (j + 1) * e_loc)``, the reference's `mine` mask: `keep` only their
    kept slots, `dest` a row of a bank of those `e_loc` experts (the sink
    row ``e_loc * capacity`` elsewhere). The rows of kept slots keep
    their rank within their expert, so the shard's buffer is those
    experts' rows of the whole one."""
    sorted_ids = r.ids.reshape(-1)[r.sort_idx]
    keep = r.keep & (sorted_ids // e_loc == j)
    dest = torch.where(keep, r.dest - j * e_loc * capacity,
                       torch.full_like(r.dest, e_loc * capacity))
    return r._replace(keep=keep, dest=dest)


def _expert_ffn(expert_in: torch.Tensor, banks: dict, spiking: bool,
                lif_cfg: Optional[LIFConfig]) -> torch.Tensor:
    """The experts' FFNs on their buffers (e, C, d), each its own GEMMs on
    its whole buffer: the gate and up products, the LIF fire at T = 1 of
    their sum (spiking) or SwiGLU, and the down product."""
    dt = expert_in.dtype
    h = torch.bmm(expert_in, banks["w_gate"].to(dt))
    u = torch.bmm(expert_in, banks["w_up"].to(dt))
    if spiking:
        h = lif_fire((h + u)[None], lif_cfg)[0]
    else:
        h = torch.nn.functional.silu(h.float()).to(dt) * u
    return torch.bmm(h, banks["w_down"].to(dt))


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, normalize_weights: bool = True,
              spiking: bool = False, lif_cfg: Optional[LIFConfig] = None,
              dispatch_groups: int = 1,
              shared_mlp: Optional[Callable] = None,
              placed=None) -> torch.Tensor:
    """x (..., N, D) -> (..., N, D); every leading axis (T included) is
    flattened into the routed tokens.

    `dispatch_groups` g > 1 routes the tokens in g equal groups, each with
    its own capacity (the reference's data-shard-local dispatch; one
    device here, the same arithmetic); a token count g does not divide
    falls back to one group. `shared_mlp(p, x)` replaces `mlp_apply` for
    the shared experts (`placement.mlp`: their d_ff split over the model
    positions).

    `placed` (a `placement.Placement`) runs it on a rank mesh as the
    one-process MoE on the global batch: x holds this rank's rows of it
    along dim -3 (the batch axis of the LM's (T, B, N, D), (B, N, D) and
    decode inputs), which every batch rank all-gathers in the
    reference's (T, B, N) order (`placement.global_rows`); routing,
    capacity, the stable sort, the drops, the dispatch groups, the
    combine and the shared experts' fire along the flattened token axis
    then run on the global tokens, the same on every rank, and each rank
    keeps its own rows of the output (`placement.own_rows`). The routed
    experts run as `param_specs` splits their banks
    (`Placement.experts`): each model rank's own experts on their whole
    (C, d) buffers, their outputs all-gathered over `model` (expert
    parallelism: bit for bit the one-process MoE); or each rank's
    columns of every expert's d_ff, the partial outputs summed over
    `model` in f32 (`placement.row_parallel`); or whole. Under `pure_fsdp`
    every rank holds other rows and runs the whole MoE. Under `witness`
    on a one-process mesh each model position runs its experts (or its
    columns) as a rank does."""
    rows = placed.rows if placed is not None else None
    xg = placement.global_rows(x, rows)
    d = x.shape[-1]
    xt = xg.reshape(-1, d)
    s = xt.shape[0]
    split = placed.experts() if placed is not None else None
    # a rank's own experts are 1/m of the bank
    e_bank = p["w_gate"].shape[0] * (
        placed.m if split == "experts" and placed.ranked else 1)
    g = max(1, dispatch_groups)
    if s % g:
        g = 1
    s_loc = s // g
    capacity = capacity_of(s_loc, top_k, p["router"].shape[-1],
                           capacity_factor)
    routes = [route(p["router"], xl, top_k=top_k, capacity=capacity,
                    e_bank=e_bank, normalize_weights=normalize_weights)
              for xl in xt.reshape(g, s_loc, d)]
    names = ("w_gate", "w_up", "w_down")

    def expert_in(xx, rr, e):
        """(e, g*C, d): each expert's rows, group by group (the
        reference's (g, e, C, d) -> (e, g*C, d) regroup). The reference
        constrains these buffers to `data` / `model` shards
        (`_maybe_constrain`, a GSPMD hint); the port places them itself:
        whole on one process, a model rank's own experts on a rank
        mesh."""
        bufs = [_dispatch(xl, r, e, capacity)
                for xl, r in zip(xx.reshape(g, s_loc, d), rr)]
        return torch.stack(bufs, 1).reshape(e, g * capacity, d)

    if split == "experts":
        # Each model position's own experts on their whole buffers; the
        # dispatch of the tokens into them enters as the position's own
        # copy (its cotangent summed over the positions).
        m = placed.m
        e_loc = e_bank // m
        if placed.ranked:
            j = placed.mesh.coords()["model"]
            copies = {j: placement.ReplicaCopy.apply(xt, placed.group)}
        else:
            copies = dict(enumerate(placement.Split.apply(xt, m)))
        outs = []
        for j, xj in copies.items():
            banks = {k: p[k] if placed.ranked
                     else p[k][j * e_loc:(j + 1) * e_loc] for k in names}
            outs.append(_expert_ffn(expert_in(
                xj, [_shard(r, j, e_loc, capacity) for r in routes],
                e_loc), banks, spiking, lif_cfg))
        expert_out = placement.gather_blocks(outs[0], 0, placed.group) \
            if placed.ranked else torch.cat(outs)
    elif split == "ffn":
        expert_out = placement.row_parallel(
            placed, lambda xx, pp: _expert_ffn(xx, pp, spiking, lif_cfg),
            expert_in(xt, routes, e_bank), {k: p[k] for k in names},
            placement.MLP_CUTS)
    else:
        expert_out = _expert_ffn(expert_in(xt, routes, e_bank), p, spiking,
                                 lif_cfg)

    out_g = expert_out.reshape(e_bank, g, capacity, d).transpose(0, 1)
    combined = torch.cat([_combine(out_g[i], routes[i], s_loc, top_k)
                          for i in range(g)])
    if "shared" in p:
        shared = mlp_apply(p["shared"], xt, spiking=spiking,
                           lif_cfg=lif_cfg) if shared_mlp is None \
            else shared_mlp(p["shared"], xt)
        combined = combined + shared.reshape(s, d)
    return placement.own_rows(combined.reshape(xg.shape), rows)


def _ep_block(xl: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor, *, j: int, e_loc: int,
              top_k: int, capacity: int, normalize_weights: bool,
              spiking: bool, lif_cfg: Optional[LIFConfig]) -> torch.Tensor:
    """The reference's shard_map `block` for model position j: route the
    rows xl (s_loc, d) on the whole router, keep the slots of the j-th
    `e_loc` experts, run those experts' FFNs on their banks (wg, wu, wd:
    e_loc experts each) and combine into this position's partial output
    (s_loc, d) in xl's dtype."""
    s_loc = xl.shape[0]
    r = _shard(route(router, xl, top_k=top_k, capacity=capacity,
                     e_bank=router.shape[-1],
                     normalize_weights=normalize_weights), j, e_loc, capacity)
    eo = _expert_ffn(_dispatch(xl, r, e_loc, capacity),
                     {"w_gate": wg, "w_up": wu, "w_down": wd}, spiking,
                     lif_cfg)
    return _combine(eo, r, s_loc, top_k)


def moe_apply_shard_map(p: dict, x: torch.Tensor, *, top_k: int,
                        capacity_factor: float = 1.25,
                        normalize_weights: bool = True,
                        spiking: bool = False,
                        lif_cfg: Optional[LIFConfig] = None,
                        mesh=None,
                        shared_mlp: Optional[Callable] = None,
                        placed=None) -> torch.Tensor:
    """The manual expert-parallel MoE, the reference's
    `moe_apply_shard_map`: the flattened tokens split into contiguous
    data shards over (pod, data); every `model` position holds every
    token of its data shard, keeps the slots routed to its own `e_loc`
    experts, runs their FFNs, and the partial outputs are summed over
    `model`; the shared experts run outside, on every token.

    `mesh` None or without a `model` axis (or not a `launch.mesh.Mesh`):
    `moe_apply` with one dispatch group. On a rank mesh
    (`launch.mesh.RankMesh`) this process is one (data, model) position:
    x holds its rows of the global batch along dim -3, all-gathered over
    the batch ranks (`placed.rows`; the (pod, data) ranks where `placed`
    is None) into the reference's flattened (T, B, N) tokens, of which
    the rank routes the reference's data shard, the contiguous chunk its
    (pod, data) coordinates index (capacity from it). Its banks are its
    own `local_params` slice (or the whole bank, sliced here); the sum
    is an `all_reduce` over `axis_group("model")`; the data shards'
    outputs are all-gathered over (pod, data) and each rank keeps its own
    rows. Its gradients are `moe_apply`'s: the shard's rows and the
    router enter through `ReplicaCopy` over `model` (where, under
    `pure_fsdp`, the model ranks hold other rows, the output does
    instead, and the batch gathers' reduce-scatters sum the rest). On a
    one-process mesh the same block runs once per data shard and model
    position, the partials summed in f32 in position order
    (`placement.position_sum`: the yardstick of the rank form, bit for
    bit with it on two model ranks). `shared_mlp(p, x)` replaces
    `mlp_apply` for the shared experts (`placement.mlp`: their d_ff
    split over the model positions)."""
    from repro_torch.launch.mesh import Mesh, RankMesh, \
        refuse_distinct_devices
    kw = dict(top_k=top_k, normalize_weights=normalize_weights,
              spiking=spiking, lif_cfg=lif_cfg)
    if not isinstance(mesh, Mesh) or "model" not in mesh.shape:
        return moe_apply(p, x, capacity_factor=capacity_factor,
                         shared_mlp=shared_mlp, placed=placed, **kw)
    refuse_distinct_devices(mesh, "expert-parallel MoE")
    rank_mesh = isinstance(mesh, RankMesh)
    pure = placed is not None and placed.cfg.pure_fsdp
    rows = placed.rows if placed is not None else placement.batch_group(mesh)
    xg = placement.global_rows(x, rows)
    d = x.shape[-1]
    xt = xg.reshape(-1, d)
    s = xt.shape[0]
    e = p["router"].shape[-1]
    m = mesh.shape["model"]
    names = ("w_gate", "w_up", "w_down")
    # A bank narrower than the router is a rank's `local_params` slice; a
    # whole bank is cut here, rows [j * e_loc, (j + 1) * e_loc).
    local = rank_mesh and p["w_gate"].shape[0] < e
    if not local and p["w_gate"].shape[0] % m:
        raise ValueError(f"{p['w_gate'].shape[0]} experts do not split "
                         f"over model={m}")
    e_loc = p["w_gate"].shape[0] // (1 if local else m)

    def banks(j):
        return tuple(p[k] if local else p[k][j * e_loc:(j + 1) * e_loc]
                     for k in names)
    shard_axes = [a for a in ("pod", "data") if a in mesh.shape]
    n_b = 1
    for a in shard_axes:
        n_b *= mesh.shape[a]
    if s % n_b:
        raise ValueError(f"{s} rows do not split into {n_b} data shards")
    s_loc = s // n_b
    capacity = capacity_of(s_loc, top_k, e, capacity_factor)
    if rank_mesh:
        group = mesh.axis_group("model")
        c, i = mesh.coords(), 0
        for a in shard_axes:
            i = i * mesh.shape[a] + c[a]
        xl, router = xt[i * s_loc:(i + 1) * s_loc], p["router"]
        if not pure:
            xl = placement.ReplicaCopy.apply(xl, group)
            router = placement.ReplicaCopy.apply(router, group)
        partial = _ep_block(xl, router, *banks(c["model"]), j=c["model"],
                            e_loc=e_loc, capacity=capacity, **kw)
        out = placement.global_rows(placement.PartialSum.apply(
            partial, group), placement.batch_group(mesh), dim=0)
        if pure:
            out = placement.ReplicaCopy.apply(out, group)
    else:
        # Each position takes its own copy of its operands
        # (`placement.Split`) as a rank's pass `ReplicaCopy`: the backward
        # sums their cotangents as the ranks do.
        outs = []
        for xl in xt.reshape(n_b, s_loc, d):
            outs.append(placement.position_sum(
                _ep_block(xj, rj, *banks(j), j=j, e_loc=e_loc,
                          capacity=capacity, **kw)
                for j, (xj, rj) in enumerate(zip(
                    placement.Split.apply(xl, m),
                    placement.Split.apply(p["router"], m)))))
        out = torch.cat(outs)
    if "shared" in p:
        shared = mlp_apply(p["shared"], xt, spiking=spiking,
                           lif_cfg=lif_cfg) if shared_mlp is None \
            else shared_mlp(p["shared"], xt)
        out = out + shared.reshape(s, d)
    return placement.own_rows(out.reshape(xg.shape), rows)


def dropped_assignments(p: dict, x: torch.Tensor, *, top_k: int,
                        capacity_factor: float = 1.25,
                        dispatch_groups: int = 1,
                        shard: Optional[tuple] = None) -> int:
    """How many (token, expert) assignments `moe_apply` on x drops for
    capacity (a host read; for reports, not on the model's path).
    `shard` (j, e_loc): only those to experts [j * e_loc, (j + 1) *
    e_loc), one model rank's share of the expert-parallel MoE's drops."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    g = max(1, dispatch_groups)
    if xt.shape[0] % g:
        g = 1
    s_loc = xt.shape[0] // g
    capacity = capacity_of(s_loc, top_k, p["router"].shape[-1],
                           capacity_factor)
    total = 0
    for xl in xt.reshape(g, s_loc, d):
        r = route(p["router"], xl, top_k=top_k, capacity=capacity,
                  e_bank=p["w_gate"].shape[0])
        dropped = ~r.keep
        if shard is not None:
            j, e_loc = shard
            dropped &= r.ids.reshape(-1)[r.sort_idx] // e_loc == j
        total += int(dropped.sum())
    return total


def aux_load_balance_loss(logits: torch.Tensor, ids: torch.Tensor,
                          n_experts: int, top_k: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss: n_experts times the
    dot of the mean router probabilities and each expert's share of the
    top-k slots."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=0)
    one_hot = torch.nn.functional.one_hot(ids.long(), n_experts).float() \
        .sum(dim=1) / top_k
    ce = one_hot.mean(dim=0)
    return n_experts * (me * ce).sum()
