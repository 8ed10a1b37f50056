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
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from repro_torch.core.lif import LIFConfig
from repro_torch.launch.mesh import MULTI_PROCESS_ITEM
from .layers import bank_init, dense_init, lif_fire, mlp_apply, mlp_init

# What a mesh still needs here (the weight gathers of pure FSDP, placement
# beyond the expert banks): the rest of ROADMAP queue 1 item 8b.
MESH_ITEM = MULTI_PROCESS_ITEM


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
          capacity: int, e_bank: int, normalize_weights: bool = True,
          shard: Optional[tuple] = None) -> Routing:
    """Top-k routing of the tokens xl (s, d) and their rank-within-expert
    capacity check. A dropped slot's `dest` is the sink row
    ``e_bank * capacity`` past the buffer. `shard` (j, e_loc): keep only
    the slots of experts ``[j * e_loc, (j + 1) * e_loc)`` (the reference's
    `mine` mask), with `dest` a row of that shard's bank of `e_loc`
    experts (`e_bank` is then ignored)."""
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
    if shard is None:
        dest = torch.where(keep, sorted_ids * capacity + rank,
                           torch.full_like(rank, e_bank * capacity))
    else:
        j, e_loc = shard
        keep = keep & (sorted_ids // e_loc == j)         # my experts only
        dest = torch.where(keep, (sorted_ids % e_loc) * capacity + rank,
                           torch.full_like(rank, e_loc * capacity))
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


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, normalize_weights: bool = True,
              spiking: bool = False, lif_cfg: Optional[LIFConfig] = None,
              dispatch_groups: int = 1) -> torch.Tensor:
    """x (..., N, D) -> (..., N, D); every leading axis (T included) is
    flattened into the routed tokens.

    `dispatch_groups` g > 1 routes the tokens in g equal groups, each with
    its own capacity (the reference's data-shard-local dispatch; one
    device here, the same arithmetic); a token count g does not divide
    falls back to one group."""
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    s = xt.shape[0]
    e_bank = p["w_gate"].shape[0]
    g = max(1, dispatch_groups)
    if s % g:
        g = 1
    s_loc = s // g
    capacity = capacity_of(s_loc, top_k, p["router"].shape[-1],
                           capacity_factor)
    routes, bufs = [], []
    for xl in xt.reshape(g, s_loc, d):
        r = route(p["router"], xl, top_k=top_k, capacity=capacity,
                  e_bank=e_bank, normalize_weights=normalize_weights)
        routes.append(r)
        bufs.append(_dispatch(xl, r, e_bank, capacity))
    # (g, e_bank, C, d) -> (e_bank, g*C, d): each expert's rows, group by
    # group. The reference constrains these buffers to `data` / `model`
    # shards here (`_maybe_constrain`, a GSPMD hint); the single-controller
    # port holds them whole on one device, so under a logical mesh the
    # constraints have nothing to act on and are left out.
    expert_in = torch.stack(bufs, 1).reshape(e_bank, g * capacity, d)

    h = torch.bmm(expert_in, p["w_gate"].to(xt.dtype))
    u = torch.bmm(expert_in, p["w_up"].to(xt.dtype))
    if spiking:
        h = lif_fire((h + u)[None], lif_cfg)[0]
    else:
        h = torch.nn.functional.silu(h.float()).to(xt.dtype) * u
    expert_out = torch.bmm(h, p["w_down"].to(xt.dtype))

    out_g = expert_out.reshape(e_bank, g, capacity, d).transpose(0, 1)
    combined = torch.cat([_combine(out_g[i], routes[i], s_loc, top_k)
                          for i in range(g)])
    if "shared" in p:
        combined = combined + mlp_apply(
            p["shared"], xt, spiking=spiking, lif_cfg=lif_cfg).reshape(s, d)
    return combined.reshape(orig_shape)


class _ModelCopy(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the `model`
    group: a replicated operand (the input rows, the router) whose
    cotangent each model rank holds only its own experts' part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.launch import distributed
        return distributed.all_reduce_(g.contiguous().clone(),
                                       ctx.group), None


class _ModelSum(torch.autograd.Function):
    """The EP combine: the partial outputs summed over the `model` group
    (`all_reduce`); the backward passes the output cotangent through, as
    every model rank holds the whole of it."""

    @staticmethod
    def forward(ctx, partial, group):
        from repro_torch.launch import distributed
        return distributed.all_reduce_(partial.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


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
    r = route(router, xl, top_k=top_k, capacity=capacity, e_bank=e_loc,
              normalize_weights=normalize_weights, shard=(j, e_loc))
    expert_in = _dispatch(xl, r, e_loc, capacity)
    h = torch.bmm(expert_in, wg.to(xl.dtype))
    u = torch.bmm(expert_in, wu.to(xl.dtype))
    if spiking:
        h = lif_fire((h + u)[None], lif_cfg)[0]
    else:
        h = torch.nn.functional.silu(h.float()).to(xl.dtype) * u
    eo = torch.bmm(h, wd.to(xl.dtype))
    return _combine(eo, r, s_loc, top_k)


def moe_apply_shard_map(p: dict, x: torch.Tensor, *, top_k: int,
                        capacity_factor: float = 1.25,
                        normalize_weights: bool = True,
                        spiking: bool = False,
                        lif_cfg: Optional[LIFConfig] = None,
                        mesh=None) -> torch.Tensor:
    """The manual expert-parallel MoE, the reference's
    `moe_apply_shard_map`: every `model` position holds every token of its
    data shard, keeps the slots routed to its own `e_loc` experts, runs
    their FFNs, and the partial outputs are summed over `model`; the
    shared experts run outside, on every token.

    `mesh` None or without a `model` axis (or not a `launch.mesh.Mesh`):
    `moe_apply` with one dispatch group. On a rank mesh
    (`launch.mesh.RankMesh`) this process is one model position: x holds
    its data shard's rows (capacity from them), the banks are its own
    `local_params` slice (or the whole bank, sliced here), and the sum is
    an `all_reduce` over `axis_group("model")` whose backward passes the
    cotangent through; the input rows' and the router's cotangents are
    summed over the same group, so the gradients are `moe_apply`'s. On a
    one-process mesh the same block runs once per data shard and model
    position, the partials summed in position order (the yardstick of the
    rank form, bit for bit with it on two ranks)."""
    from repro_torch.launch.mesh import Mesh, RankMesh, \
        refuse_distinct_devices
    kw = dict(top_k=top_k, normalize_weights=normalize_weights,
              spiking=spiking, lif_cfg=lif_cfg)
    if not isinstance(mesh, Mesh) or "model" not in mesh.shape:
        return moe_apply(p, x, capacity_factor=capacity_factor, **kw)
    refuse_distinct_devices(mesh, "expert-parallel MoE")
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    s = xt.shape[0]
    e = p["router"].shape[-1]
    m = mesh.shape["model"]
    rank_mesh = isinstance(mesh, RankMesh)
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
    if rank_mesh:
        n_b, j0 = 1, mesh.coords()["model"]
    else:
        n_b = 1
        for a in ("pod", "data"):
            n_b *= mesh.shape.get(a, 1)
        if s % n_b:
            raise ValueError(f"{s} rows do not split into {n_b} data "
                             f"shards")
    s_loc = s // n_b
    capacity = capacity_of(s_loc, top_k, e, capacity_factor)
    if rank_mesh:
        group = mesh.axis_group("model")
        xl = _ModelCopy.apply(xt, group)
        router = _ModelCopy.apply(p["router"], group)
        partial = _ep_block(xl, router, *banks(j0), j=j0, e_loc=e_loc,
                            capacity=capacity, **kw)
        out = _ModelSum.apply(partial, group)
    else:
        outs = []
        for xl in xt.reshape(n_b, s_loc, d):
            acc = None
            for j in range(m):
                part = _ep_block(xl, p["router"], *banks(j), j=j,
                                 e_loc=e_loc, capacity=capacity, **kw)
                acc = part if acc is None else acc + part
            outs.append(acc)
        out = torch.cat(outs)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], xt, spiking=spiking,
                              lif_cfg=lif_cfg).reshape(s, d)
    return out.reshape(orig_shape)


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
