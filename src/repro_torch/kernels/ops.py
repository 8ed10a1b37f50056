"""Public wrappers around the kernels: shape plumbing, packing and the
event-metadata hand-off, so model code can call them on arbitrary shapes.

Each wrapper launches its CUDA kernel for CUDA tensors and the kernel's
plain version for CPU tensors (the choice is made by the kernel module
from the tensor's device, nowhere else).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.events import EventTensor
from repro_torch.core.spikes import (PACK, TileCSR, build_csr, pack_spikes,
                                     ragged_tile_occupancy, unpack_spikes)
from . import apec_kernel, lif_scan, sdsa_kernel, spike_matmul as _csr


def _pad_to(x: torch.Tensor, axis: int, mult: int):
    """Zero-pad `axis` of `x` up to a multiple of `mult`; returns
    (padded, original size)."""
    size = x.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return x, size
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis % x.ndim) + 1] = pad
    return F.pad(x, widths), size


def lif(x: torch.Tensor, decay: float = 0.5, v_th: float = 1.0,
        soft_reset: bool = True, surrogate_alpha: float = 2.0) -> torch.Tensor:
    """Fused LIF over the leading time axis, any trailing shape. The kernel
    walks neurons flat, so no padding to lane multiples is needed.
    Differentiable: the surrogate backward kernel runs under autograd."""
    t = x.shape[0]
    out = lif_scan.LIFScanSG.run(x.reshape(t, -1).contiguous(), decay=decay,
                                 v_th=v_th, soft_reset=soft_reset,
                                 surrogate_alpha=surrogate_alpha)
    return out.reshape(x.shape)


def lif_occ(x: torch.Tensor, decay: float = 0.5, v_th: float = 1.0,
            soft_reset: bool = True, surrogate_alpha: float = 2.0):
    """Fused LIF that also emits the (128, 128)-tiled occupancy map of its
    own spike output — the full-event producer.

    x: (T, ..., K) drive -> (spikes (T, ..., K),
    occupancy (ceil(T*R/128), ceil(K/128)) int32,
    chunks (ceil(T*R/128)*16, ceil(K/128)) int32), R = prod of the middle
    axes, which must divide by 8. The maps come from the kernel's per-chunk
    counts plus a reduction over the small count map, never a re-read of
    the spikes. The spikes are differentiable (surrogate backward kernel);
    the maps are metadata and carry no gradient.
    """
    t, k = x.shape[0], x.shape[-1]
    r = math.prod(x.shape[1:-1])
    if r % 8:
        raise ValueError(f"middle axes {tuple(x.shape[1:-1])} (R={r}) must "
                         f"divide by 8")
    s, cnt = lif_scan.LIFScanOccSG.run(x.reshape(t, r, k).contiguous(),
                                       decay=decay, v_th=v_th,
                                       soft_reset=soft_reset,
                                       surrogate_alpha=surrogate_alpha)
    # (T, R/8, KT) chunk counts -> (ceil(T*R/128), KT) matmul tiles: the
    # flattened chunk (t, a) sits at t*(R/8)+a, so 16 consecutive chunks
    # are one 128-row tile (zero-padded tail chunks match the consumers'
    # zero-padded rows).
    kt = cnt.shape[-1]
    cnt2, _ = _pad_to(cnt.reshape(t * (r // 8), kt), 0, 16)
    occ = cnt2.reshape(-1, 16, kt).sum(dim=1, dtype=torch.int32)
    return s.reshape(x.shape), occ, cnt2


def sdsa_or(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """OR-form SDSA on dense binary (..., N, d) tensors; bit-packed inside
    and run through the packed kernel."""
    lead = q.shape[:-2]
    n, d = q.shape[-2:]
    block_n = min(256, n + (-n) % 8)

    def prep(x):
        x, _ = _pad_to(x.reshape(-1, n, d), 2, PACK)
        x, _ = _pad_to(pack_spikes(x, axis=-1), 1, block_n)
        return x.contiguous()

    out_p = sdsa_kernel.sdsa_packed(prep(q), prep(k), prep(v))
    out = unpack_spikes(out_p, axis=-1, dtype=q.dtype)[:, :n, :d]
    return out.reshape(lead + (n, d))


def padded_occupancy(s: torch.Tensor, block_m: int = 128,
                     block_k: int = 128) -> torch.Tensor:
    """The occupancy pre-pass as the matmul consumers tile it: lead axes
    flattened into rows, rows and K zero-padded to the tiling (counted in
    place, without a padded copy)."""
    return ragged_tile_occupancy(s.reshape(-1, s.shape[-1]), block_m,
                                 block_k)


def _check_map(occupancy: torch.Tensor, grid) -> None:
    if tuple(occupancy.shape) != tuple(grid):
        raise ValueError(
            f"occupancy map {tuple(occupancy.shape)} does not match the "
            f"padded {tuple(grid)} tile grid — built for a different "
            f"flattening or tiling")


def spike_matmul(s, w: torch.Tensor, *,
                 occupancy: torch.Tensor | None = None) -> torch.Tensor:
    """Predicated spike matmul for (..., M, K) x (K, N) on the 128x128
    tile grid: every tile is visited and the map gates its product.

    `s` may be an `EventTensor`, whose carried map replaces the pre-pass;
    an explicit `occupancy` wins over it. A supplied map is validated
    against the padded tile grid of the flattened s and never re-derived;
    the dense pre-pass runs only when no map is given. Ragged M, K and N
    are masked in the kernel (no padded operand copies).
    """
    tile = _csr.TILE
    if isinstance(s, EventTensor):
        if occupancy is None:
            occupancy = s.occupancy_for(tile, tile)
        s = s.spikes
    lead = s.shape[:-2]
    m, k = s.shape[-2:]
    n = w.shape[-1]
    s2 = s.reshape(-1, k).float().contiguous()
    if occupancy is None:
        occupancy = padded_occupancy(s2, tile, tile)
    else:
        _check_map(occupancy, (-(-s2.shape[0] // tile), -(-k // tile)))
    out = _csr.spike_matmul_pred(s2, w.float().contiguous(),
                                 occupancy.to(torch.int32).contiguous())
    return out.reshape(lead + (m, n))


def spike_matmul_csr(s, w: torch.Tensor, csr: TileCSR | None = None, *,
                     occupancy: torch.Tensor | None = None) -> torch.Tensor:
    """Event-compacted spike matmul for (..., M, K) x (K, N) on the
    128x128 tile grid.

    `s` may be an `EventTensor` (carried map + cached work list). `csr`:
    a precomputed `TileCSR` for this tiling. `occupancy`: a precomputed
    map for callers holding occupancy but no work list; the compaction
    runs on the small map and the dense `tile_occupancy` pass is skipped.
    A map or work list for another tile grid is rejected.
    """
    tile = _csr.TILE
    if isinstance(s, EventTensor):
        if csr is None and occupancy is None:
            csr = s.csr(tile, tile)          # None when no map is carried
        s = s.spikes
    lead = s.shape[:-2]
    m, k = s.shape[-2:]
    n = w.shape[-1]
    s2 = s.reshape(-1, k).contiguous()
    grid = (-(-s2.shape[0] // tile), -(-k // tile))
    if csr is None:
        if occupancy is None:
            occupancy = padded_occupancy(s2, tile, tile)
        else:
            _check_map(occupancy, grid)
        csr = build_csr(occupancy, tile, tile)
    out = _csr.spike_matmul_csr(s2, w.float().contiguous(), csr)
    return out.reshape(lead + (m, n))


# ------------------------------------------------------------------ APEC
def apec_decompose(s: torch.Tensor, g: int = 2):
    """Dense binary (P, C) spikes -> (overlap (P/g, C), residual (P, C))
    through the packed bitwise kernel. P must divide by g. Only the packing
    pads (C up to whole 32-bit words); the kernel takes any word count."""
    p, c = s.shape
    if p % g:
        raise ValueError(f"positions {p} not divisible by group {g}")
    sp, _ = _pad_to(s, 1, PACK)
    ov_p, res_p = apec_kernel.apec_decompose_packed(
        pack_spikes(sp, axis=-1).contiguous(), g)
    ov = unpack_spikes(ov_p, axis=-1, dtype=s.dtype)[:, :c]
    res = unpack_spikes(res_p, axis=-1, dtype=s.dtype)[:, :c]
    return ov, res


def _group_occupancy(occ, g: int, rows: int, block_m: int = 128):
    """Conservative overlap-operand map derived from the carried map of
    the undecomposed spikes: the overlap tile at row-tile i unions group
    members living in s row-tiles [g*i, g*i+g) (AND-of-group is a subset
    of each member, so a zero s-tile group guarantees a zero overlap
    tile). Only derivable when the row tiling regroups exactly
    (rows % (block_m*g) == 0); otherwise None (the caller re-derives)."""
    if occ is None or rows % (block_m * g):
        return None
    mt = occ.shape[0]
    return occ.reshape(mt // g, g, occ.shape[1]).sum(dim=1,
                                                     dtype=torch.int32)


def apec_matmul(s, w: torch.Tensor, g: int = 2, *, decomposed=None,
                occ_res: torch.Tensor | None = None,
                occ_ov: torch.Tensor | None = None,
                occupancy: torch.Tensor | None = None) -> torch.Tensor:
    """APEC matmul on the predicated route: the packed decompose kernel,
    then two occupancy-gated matmuls (`spike_matmul`, the predicated
    kernel) with the overlap partial sums reused across each group's
    members.

    s: (..., P, C) binary (or an `EventTensor`) with P % g == 0; w: (C, F)
    -> (..., P, F). Leading axes are flattened into the position axis
    (each row contributes whole groups when P divides by g).
    ``decomposed=(residual, overlap)`` (flattened (R, C) / (R/g, C)) skips
    the decompose, with per-operand maps ``occ_res`` / ``occ_ov``. A
    carried ``occupancy`` (of the undecomposed s) gates both products
    conservatively: residual tiles are a subset of s tiles, and the
    overlap map folds g s-row-tiles (`_group_occupancy`).
    """
    if isinstance(s, EventTensor):
        if occupancy is None:
            occupancy = s.occupancy_for(_csr.TILE, _csr.TILE)
        s = s.spikes
    lead = s.shape[:-2]
    p, c = s.shape[-2:]
    if p % g:
        raise ValueError(f"positions {p} not divisible by group {g}")
    s2 = s.reshape(-1, c)
    if decomposed is None:
        ov, res = apec_decompose(s2, g)              # packed bitwise kernel
    else:
        res, ov = decomposed
    if occupancy is not None and occ_res is None:
        occ_res = occupancy                          # res tiles <= s tiles
        if occ_ov is None:
            occ_ov = _group_occupancy(occupancy, g, s2.shape[0])
    psum_ov = spike_matmul(ov, w, occupancy=occ_ov)      # cached sums
    psum_res = spike_matmul(res, w, occupancy=occ_res)   # residuals
    out = psum_res + psum_ov.repeat_interleave(g, 0)     # reuse
    return out.reshape(lead + (p, w.shape[-1])).to(w.dtype)


def apec_union_worklist(res: torch.Tensor, ov: torch.Tensor, g: int,
                        occupancy: torch.Tensor | None = None,
                        csr: TileCSR | None = None):
    """(union `TileCSR`, residual per-step counts, overlap per-step counts)
    for the fused APEC kernel on the 128 x 128 grid of res.

    Without a map, one dense pre-pass per operand (residual tiles 128 x
    128, overlap tiles 128/g x 128, the same grid) and the work list of
    their sum: a k-tile enters when either operand's tile holds events,
    and each dot is gated by its own counts. A carried map of the
    UNDECOMPOSED spikes is the union gate itself (an s tile holds events
    iff its residual or overlap tile does): it is checked against the grid,
    the work list compacts from it (or `csr`, its cached compaction, is
    used) and both dots are gated on it, with no dense pre-pass."""
    tile = _csr.TILE
    grid = (-(-res.shape[0] // tile), -(-res.shape[1] // tile))
    if occupancy is not None:
        _check_map(occupancy, grid)
        if csr is None:
            csr = build_csr(occupancy, tile, tile)
        gate = (occupancy[csr.tile_m_idx.long(), csr.tile_k_idx.long()]
                * csr.valid).to(torch.int32)
        return csr, gate, gate
    occ_res = ragged_tile_occupancy(res, tile, tile)
    occ_ov = ragged_tile_occupancy(ov, tile // g, tile)
    csr = build_csr(occ_res + occ_ov, tile, tile)
    steps = (csr.tile_m_idx.long(), csr.tile_k_idx.long())
    return (csr, (occ_res[steps] * csr.valid).to(torch.int32),
            (occ_ov[steps] * csr.valid).to(torch.int32))


def apec_matmul_csr(s, w: torch.Tensor, g: int = 2, *,
                    occupancy: torch.Tensor | None = None) -> torch.Tensor:
    """APEC matmul fused into one event-compacted kernel pass.

    The packed decompose kernel, then one union work list
    (`apec_union_worklist`) and one launch of the fused kernel, in which
    each weight k-tile is staged once and feeds the residual AND overlap
    dots, and the overlap partial sum lands in its group's g output rows in
    the epilogue (no repeat pass).

    `s` may be an `EventTensor` (its carried map and cached work list), and
    `occupancy` a precomputed map of the UNDECOMPOSED spikes: either
    replaces the two dense pre-passes. Ragged rows, K and N are masked in
    the kernel (no padded copies).
    """
    tile = _csr.TILE
    csr = None
    if isinstance(s, EventTensor):
        if occupancy is None:
            occupancy = s.occupancy_for(tile, tile)
            csr = s.csr(tile, tile)                  # None without a map
        s = s.spikes
    lead = s.shape[:-2]
    p, c = s.shape[-2:]
    if p % g:
        raise ValueError(f"positions {p} not divisible by group {g}")
    if tile % g:
        raise ValueError(f"block_m {tile} not divisible by group {g}")
    s2 = s.reshape(-1, c)
    ov, res = apec_decompose(s2, g)                  # packed bitwise kernel
    csr, occ_res, occ_ov = apec_union_worklist(res, ov, g, occupancy, csr)
    out = _csr.apec_matmul_csr(res.float().contiguous(),
                               ov.float().contiguous(),
                               w.float().contiguous(), g, csr, occ_res,
                               occ_ov)
    return out.reshape(lead + (p, w.shape[-1])).to(w.dtype)
