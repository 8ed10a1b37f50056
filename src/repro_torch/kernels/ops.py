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

from repro_torch.core.econv import conv_pads
from repro_torch.core.events import EventTensor
from repro_torch.core.spikes import (PACK, TileCSR, build_csr,
                                     pack_spikes_padded, packed_width,
                                     ragged_packed_tile_occupancy,
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
            soft_reset: bool = True, surrogate_alpha: float = 2.0,
            packed: bool = False):
    """Fused LIF that also emits the (128, 128)-tiled occupancy map of its
    own spike output — the full-event producer.

    x: (T, ..., K) drive -> (spikes (T, ..., K),
    occupancy (ceil(T*R/128), ceil(K/128)) int32,
    chunks (ceil(T*R/128)*16, ceil(K/128)) int32), R = prod of the middle
    axes (any R: the chunks are 8-row chunks of the flattened (T*R, K)
    spikes, as the matmul consumes them). The maps come from the kernel's
    per-chunk counts plus a reduction over the small count map, never a
    re-read of the spikes. The spikes are differentiable (surrogate
    backward kernel); the maps are metadata and carry no gradient.

    ``packed=True`` is the forward-only packed fire: the first element is
    the uint32 words (T, ..., ceil(K/32)) that the kernel writes instead
    of spikes (the drive is detached, as `repro` stops its gradient); the
    maps are the same.
    """
    t, k = x.shape[0], x.shape[-1]
    r = math.prod(x.shape[1:-1])
    xr = x.reshape(t, r, k).contiguous()
    if packed:
        s, cnt = lif_scan.lif_counts_packed(xr.detach(), decay=decay,
                                            v_th=v_th, soft_reset=soft_reset)
        payload = s.reshape(tuple(x.shape[:-1]) + (packed_width(k),))
    else:
        s, cnt = lif_scan.LIFScanOccSG.run(xr, decay=decay, v_th=v_th,
                                           soft_reset=soft_reset,
                                           surrogate_alpha=surrogate_alpha)
        payload = s.reshape(x.shape)
    # (ceil(T*R/8), KT) chunk counts -> (ceil(T*R/128), KT) matmul tiles:
    # 16 consecutive chunks are one 128-row tile (zero-padded tail chunks
    # match the consumers' zero-padded rows).
    kt = cnt.shape[-1]
    cnt2, _ = _pad_to(cnt, 0, 16)
    occ = cnt2.reshape(-1, 16, kt).sum(dim=1, dtype=torch.int32)
    return payload, occ, cnt2


def _packed_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., N, d) binary -> (prod(...), N, ceil(d/32)) uint32 words, the
    d axis zero-padded to whole words."""
    return pack_spikes_padded(x.reshape(-1, n, d)).contiguous()


def sdsa_or(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """OR-form SDSA on dense binary (..., N, d) tensors. On the card one
    launch reads the spikes where they lie (`sdsa_or_spikes`); on the CPU
    they are bit-packed and run through the word entry's plain version."""
    if q.is_cuda:
        return sdsa_kernel.sdsa_or_spikes(q, k, v)
    return sdsa_or_words(q, k, v, sdsa_kernel.sdsa_packed)


def sdsa_or_words(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kernel) -> torch.Tensor:
    """OR-form SDSA on dense binary (..., N, d) tensors through uint32
    words: pack, pad N to the TPU kernel's block, `kernel` ((BH, N, dw)
    words x3 -> Q AND status words), unpack."""
    lead = q.shape[:-2]
    n, d = q.shape[-2:]
    block_n = min(256, n + (-n) % 8)

    def prep(x):
        return _pad_to(_packed_heads(x, n, d), 1, block_n)[0].contiguous()

    out_p = kernel(prep(q), prep(k), prep(v))
    out = unpack_spikes(out_p, axis=-1, dtype=q.dtype)[:, :n, :d]
    return out.reshape(lead + (n, d))


def causal_sdsa_words(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scan) -> torch.Tensor:
    """Causal OR-form SDSA on dense binary (T, ..., N, d) tensors, T the
    micro-step axis and N the token axis, through uint32 words: pack, OR
    the kv words over T, `scan` ((BH, N, dw) words -> their prefix-OR
    over N), AND with Q, unpack."""
    t = q.shape[0]
    lead = q.shape[1:-2]
    n, d = q.shape[-2:]
    qp, kp, vp = (_packed_heads(x, n, d).view(torch.int32).reshape(
        (t, -1) + (n, packed_width(d))) for x in (q, k, v))
    kv = kp[0] & vp[0]
    for i in range(1, t):
        kv = kv | (kp[i] & vp[i])
    status = scan(kv.view(torch.uint32))
    out = (qp & status.view(torch.int32)[None]).view(torch.uint32)
    return unpack_spikes(out, axis=-1, dtype=q.dtype)[..., :d].reshape(
        (t,) + lead + (n, d))


def causal_sdsa_or(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Causal (LM) OR-form SDSA on dense binary (T, ..., N, d) tensors:
    status[i] = OR over micro-steps and tokens j <= i of K AND V,
    out[t, i] = Q[t, i] AND status[i]. On the card one launch of the
    causal kernel reads the spikes where they lie (`causal_sdsa_spikes`:
    T-fold, prefix-OR over tokens and the Q AND, any N); on the CPU the
    words route runs around the causal-status word entry's plain
    version."""
    if q.is_cuda:
        return sdsa_kernel.causal_sdsa_spikes(q, k, v)
    return causal_sdsa_words(q, k, v, sdsa_kernel.sdsa_causal_status)


def padded_occupancy(s: torch.Tensor, block_m: int = 128,
                     block_k: int = 128) -> torch.Tensor:
    """The occupancy pre-pass as the matmul consumers tile it: lead axes
    flattened into rows, rows and K zero-padded to the tiling (counted in
    place, without a padded copy)."""
    return ragged_tile_occupancy(s.reshape(-1, s.shape[-1]), block_m,
                                 block_k)


def support_map(s: torch.Tensor, packed_k: int | None = None
                ) -> torch.Tensor:
    """The payload's own (128, 128) tile map, as the guard audits a carried
    map against it: nonzeros of dense (..., K) spikes, or popcounts of
    (..., ceil(K/32)) words with ``packed_k`` (4 words a k-tile), the lead
    axes flattened into rows, counted in place -> (ceil(R/128),
    ceil(K/128)) int32."""
    tile = _csr.TILE
    if packed_k is None:
        return padded_occupancy(s, tile, tile)
    return ragged_packed_tile_occupancy(s.reshape(-1, s.shape[-1]), tile,
                                        tile)


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
                     occupancy: torch.Tensor | None = None,
                     pipeline: bool = False) -> torch.Tensor:
    """Event-compacted spike matmul for (..., M, K) x (K, N) on the
    128x128 tile grid.

    `s` may be an `EventTensor` (carried map + cached work list). `csr`:
    a precomputed `TileCSR` for this tiling. `occupancy`: a precomputed
    map for callers holding occupancy but no work list; the compaction
    runs on the small map and the dense `tile_occupancy` pass is skipped.
    A map or work list for another tile grid is rejected. `pipeline=True`
    runs the pipelined kernel (`spike_matmul_csr_pipe`) on the
    same work list, as `repro`'s flag selects its prefetching kernel.
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
    kernel = _csr.spike_matmul_csr_pipe if pipeline else _csr.spike_matmul_csr
    out = kernel(s2, w.float().contiguous(), csr)
    return out.reshape(lead + (m, n))


# ------------------------------------------------------------------ APEC
def apec_decompose(s: torch.Tensor, g: int = 2):
    """Dense (P, C) spikes -> (overlap (P/g, C), residual (P, C)) as ones
    and zeros in s's dtype. P must divide by g. On the card one launch of
    the spike entry reads the spikes where they lie; nothing is padded,
    packed or unpacked."""
    return apec_kernel.apec_decompose_spikes(s, g)


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
    """APEC matmul on the predicated route: the decompose kernel on the
    spikes, then two occupancy-gated matmuls (`spike_matmul`, the predicated
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
        ov, res = apec_decompose(s2, g)
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
                        csr: TileCSR | None = None, *, packed: bool = False):
    """(union `TileCSR`, residual per-step counts, overlap per-step counts)
    for the fused APEC kernel on the 128 x 128 grid of res (of the spikes
    they carry, for `packed` words, whose pre-passes are word popcounts).

    Without a map, one dense pre-pass per operand (residual tiles 128 x
    128, overlap tiles 128/g x 128, the same grid) and the work list of
    their sum: a k-tile enters when either operand's tile holds events,
    and each dot is gated by its own counts. A carried map of the
    UNDECOMPOSED spikes is the union gate itself (an s tile holds events
    iff its residual or overlap tile does): it is checked against the grid,
    the work list compacts from it (or `csr`, its cached compaction, is
    used) and both dots are gated on it, with no dense pre-pass."""
    tile = _csr.TILE
    k = res.shape[1] * (PACK if packed else 1)
    grid = (-(-res.shape[0] // tile), -(-k // tile))
    if occupancy is not None:
        _check_map(occupancy, grid)
        if csr is None:
            csr = build_csr(occupancy, tile, tile)
        gate = (occupancy[csr.tile_m_idx.long(), csr.tile_k_idx.long()]
                * csr.valid).to(torch.int32)
        return csr, gate, gate
    count = ragged_packed_tile_occupancy if packed else ragged_tile_occupancy
    occ_res = count(res, tile, tile)
    occ_ov = count(ov, tile // g, tile)
    csr = build_csr(occ_res + occ_ov, tile, tile)
    steps = (csr.tile_m_idx.long(), csr.tile_k_idx.long())
    return (csr, (occ_res[steps] * csr.valid).to(torch.int32),
            (occ_ov[steps] * csr.valid).to(torch.int32))


def apec_matmul_csr(s, w: torch.Tensor, g: int = 2, *,
                    occupancy: torch.Tensor | None = None,
                    pipeline: bool = False) -> torch.Tensor:
    """APEC matmul fused into one event-compacted kernel pass.

    The decompose kernel on the spikes, then one union work list
    (`apec_union_worklist`) and one launch of the fused kernel, in which
    each weight k-tile is staged once and feeds the residual AND overlap
    dots, and the overlap partial sum lands in its group's g output rows in
    the epilogue (no repeat pass).

    `s` may be an `EventTensor` (its carried map and cached work list), and
    `occupancy` a precomputed map of the UNDECOMPOSED spikes: either
    replaces the two dense pre-passes. Ragged rows, K and N are masked in
    the kernel (no padded copies). `pipeline=True` runs the pipelined
    kernel (`apec_matmul_csr_pipe`) on the same work list, as `repro`'s
    flag selects its prefetching kernel.
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
    ov, res = apec_decompose(s2, g)
    csr, occ_res, occ_ov = apec_union_worklist(res, ov, g, occupancy, csr)
    kernel = _csr.apec_matmul_csr_pipe if pipeline else _csr.apec_matmul_csr
    out = kernel(res.float().contiguous(), ov.float().contiguous(),
                 w.float().contiguous(), g, csr, occ_res, occ_ov)
    return out.reshape(lead + (p, w.shape[-1])).to(w.dtype)


# ------------------------------------------------------- packed payload
# The packed wrappers take uint32 words with ``packed_k=`` the logical
# channel count (how dispatch threads a packed EventTensor), a packed
# EventTensor, or a dense binary operand (packed here, as `repro`'s do, so
# the registry's dense example inputs reach them). Forward only: the words
# carry no gradient. Ragged rows, K and N are masked in the kernels, so
# nothing is padded beyond the 32-bit words.
def _as_words(s, packed_k: int | None):
    """The spike operand as uint32 words (..., ceil(K/32)) -> (words, K).
    Pre-packed words are checked against `packed_width(packed_k)`, never
    reinterpreted; dense spikes are packed (pad bits zero)."""
    if isinstance(s, EventTensor):
        if s.is_packed:
            return s.packed, s.feature_size
        s, packed_k = s.spikes, None
    if packed_k is None:
        return pack_spikes_padded(s.detach()), s.shape[-1]
    if s.dtype != torch.uint32 or s.shape[-1] != packed_width(packed_k):
        raise ValueError(
            f"packed operand {tuple(s.shape)} {s.dtype} does not carry "
            f"packed_k={packed_k} channels as {packed_width(packed_k)} "
            f"uint32 words")
    return s, int(packed_k)


def _packed_rows(s, packed_k: int | None,
                 occupancy: torch.Tensor | None):
    """The spike operand as flattened (R, ceil(K/32)) words -> (words, K,
    lead shape, logical rows, occupancy, the carried map unless one is
    given)."""
    if isinstance(s, EventTensor) and occupancy is None:
        occupancy = s.occupancy_for(_csr.TILE, _csr.TILE)
    words, k = _as_words(s, packed_k)
    kw = words.shape[-1]
    return (words.reshape(-1, kw).contiguous(), k, tuple(words.shape[:-2]),
            words.shape[-2], occupancy)


def _check_weight_rows(w: torch.Tensor, k: int) -> None:
    if w.shape[0] != k:
        raise ValueError(f"weights have {w.shape[0]} rows, the packed operand "
                         f"carries {k} channels")


def spike_matmul_packed(s, w: torch.Tensor, *, packed_k: int | None = None,
                        csr: TileCSR | None = None,
                        occupancy: torch.Tensor | None = None,
                        pipeline: bool = False) -> torch.Tensor:
    """Event-compacted spike matmul on the packed payload: (..., M,
    ceil(K/32)) words with ``packed_k=K`` (or a packed `EventTensor`, or
    dense spikes) times (K, N) -> (..., M, N). The work list is the f32
    route's (tile indices are payload-agnostic); a carried or explicit
    `occupancy` skips the word popcount pre-pass. `pipeline=True` runs the
    pipelined word kernel (`spike_matmul_packed_csr_pipe`)."""
    p2, k, lead, m, occupancy = _packed_rows(s, packed_k, occupancy)
    _check_weight_rows(w, k)
    tile = _csr.TILE
    if csr is None:
        if occupancy is None:
            occupancy = ragged_packed_tile_occupancy(p2, tile, tile)
        else:
            _check_map(occupancy, (-(-p2.shape[0] // tile), -(-k // tile)))
        csr = build_csr(occupancy, tile, tile)
    kernel = _csr.spike_matmul_packed_csr_pipe if pipeline else \
        _csr.spike_matmul_packed_csr
    out = kernel(p2, w.float().contiguous(), csr)
    return out.reshape(lead + (m, w.shape[-1]))


def apec_matmul_packed(s, w: torch.Tensor, g: int = 2, *,
                       packed_k: int | None = None,
                       occupancy: torch.Tensor | None = None,
                       pipeline: bool = False) -> torch.Tensor:
    """The fused APEC matmul without leaving the words: the decompose
    kernel on the words, a union work list (the carried map gates both
    operands; without one, each operand's word popcount map), and the
    packed fused kernel, which unpacks both operands' tiles on chip.
    `pipeline=True` runs the pipelined word kernel
    (`apec_matmul_packed_csr_pipe`)."""
    p2, k, lead, p_pos, occupancy = _packed_rows(s, packed_k, occupancy)
    _check_weight_rows(w, k)
    if p2.shape[0] % g:
        raise ValueError(f"positions {p2.shape[0]} not divisible by "
                         f"group {g}")
    ov_p, res_p = apec_kernel.apec_decompose_packed(p2, g)
    csr, occ_res, occ_ov = apec_union_worklist(res_p, ov_p, g, occupancy,
                                               packed=True)
    kernel = _csr.apec_matmul_packed_csr_pipe if pipeline else \
        _csr.apec_matmul_packed_csr
    out = kernel(res_p, ov_p, w.float().contiguous(), g, csr, occ_res,
                 occ_ov)
    return out.reshape(lead + (p_pos, w.shape[-1])).to(w.dtype)


def econv_packed(s, w: torch.Tensor, *, stride: int = 1,
                 padding: str = "SAME", packed_k: int | None = None,
                 occupancy: torch.Tensor | None = None,
                 pipeline: bool = False) -> torch.Tensor:
    """Event conv with the payload packed end to end: (N, H, W, ceil(Ci/32))
    words with ``packed_k=Ci`` (or a packed `EventTensor`, or dense
    spikes) and HWIO weights -> (N, Ho, Wo, Co).

    im2col runs on the words: channels are the packed axis, so a spatial
    window of the word array is the packed patch, and kh*kw strided
    slices of the zero-padded words give (N*Ho*Wo, kh*kw*ciw) patch rows
    in feature order (kh, kw, ci-words). The weights are relaid to match:
    ci zero-padded to ciw*32 (the phantom channels meet zero weights),
    then (kh, kw, ci_pad, co). A carried `occupancy` (the dense patch
    matrix's map) is honoured only when ci % 32 == 0, where the two
    k-tilings coincide; otherwise the word popcount pre-pass runs.
    `pipeline=True` runs the pipelined word kernel.
    """
    p, ci = _as_words(s, packed_k)
    kh, kw_, ci_w, co = w.shape
    if ci_w != ci:
        raise ValueError(f"weights expect {ci_w} input channels, packed "
                         f"operand carries {ci}")
    n, h, wdt, ciw = p.shape
    ho, pt, pb = conv_pads(h, kh, stride, padding)
    wo, pl, pr = conv_pads(wdt, kw_, stride, padding)
    pp = F.pad(p.view(torch.int32), (0, 0, pl, pr, pt, pb))
    patches = torch.cat(
        [pp[:, dy:dy + (ho - 1) * stride + 1:stride,
            dx:dx + (wo - 1) * stride + 1:stride, :]
         for dy in range(kh) for dx in range(kw_)], dim=-1)
    patches = patches.reshape(n * ho * wo, kh * kw_ * ciw).view(torch.uint32)
    ci_pad = ciw * PACK
    w2 = F.pad(w.float(), (0, 0, 0, ci_pad - ci)).reshape(kh * kw_ * ci_pad,
                                                          co)
    if occupancy is not None and ci % PACK:
        occupancy = None               # the dense patch tiling does not align
    out = spike_matmul_packed(patches, w2, packed_k=kh * kw_ * ci_pad,
                              occupancy=occupancy, pipeline=pipeline)
    return out.reshape(n, ho, wo, co)


# ---------------------------------------------------------------- hybrid
# Hybrid dispatch on a CUDA map (`dispatch.use_hybrid`): the event route
# and the dense route of one call are both launched, each kernel gated by
# one device int of `hybrid_route`'s flags, so the route is chosen on the
# card from the carried map with no host read, and a CUDA graph of the
# call picks it from the map present at replay. What both routes share
# (econv's im2col, APEC's decompose) is built once.
def hybrid_route(occupancy: torch.Tensor, threshold: int) -> torch.Tensor:
    """(2,) int32 [event, dense] flags on the map's device: [1, 0] where the
    map's occupied-tile count c lies in a pow2 bucket at most `threshold`
    (`costmodel.pow2_bucket(c) <= threshold`, i.e. c < 2**threshold; no
    count at threshold -1), else [0, 1]."""
    event = (occupancy > 0).sum() < ((1 << threshold) if threshold >= 0
                                     else 0)
    return torch.stack((event, event.logical_not())).to(torch.int32)


def spike_matmul_hybrid(s: torch.Tensor, w: torch.Tensor, *,
                        occupancy: torch.Tensor,
                        route: torch.Tensor) -> torch.Tensor:
    """`spike_matmul_csr` (kernel 11, the event walk) and `spike_matmul`
    (kernel 10, predicated) on one output, each launch gated by its flag
    of `route` (`hybrid_route`): the one whose flag is set writes it.
    s: (..., M, K) spikes, w: (K, N), `occupancy` the carried map of the
    flattened s."""
    tile = _csr.TILE
    lead = s.shape[:-2]
    m, k = s.shape[-2:]
    n = w.shape[-1]
    s2 = s.reshape(-1, k).float().contiguous()
    _check_map(occupancy, (-(-s2.shape[0] // tile), -(-k // tile)))
    w2 = w.float().contiguous()
    out = torch.empty((s2.shape[0], n), dtype=torch.float32, device=s.device)
    _csr.spike_matmul_csr(s2, w2, build_csr(occupancy, tile, tile),
                          route=route[0:1], out=out)
    _csr.spike_matmul_pred(s2, w2, occupancy.to(torch.int32).contiguous(),
                           route=route[1:2], out=out)
    return out.reshape(lead + (m, n))


def apec_matmul_hybrid(s: torch.Tensor, w: torch.Tensor, g: int = 2, *,
                       occupancy: torch.Tensor,
                       route: torch.Tensor) -> torch.Tensor:
    """`apec_matmul_csr` (kernel 17) and `apec_matmul` (two kernel-10
    launches and the repeat) behind `route`'s flags, on one decompose of
    s. Kernel 17 and the residual launch write the same (M, N) sums; the
    overlap sums start at zero, so on the event route the repeat adds +0
    to kernel 17's output and changes no bit (its sums are never -0).
    `occupancy`: the carried map of the undecomposed flattened s."""
    tile = _csr.TILE
    lead = s.shape[:-2]
    p, c = s.shape[-2:]
    if p % g:
        raise ValueError(f"positions {p} not divisible by group {g}")
    if tile % g:
        raise ValueError(f"block_m {tile} not divisible by group {g}")
    n = w.shape[-1]
    s2 = s.reshape(-1, c)
    ov, res = apec_decompose(s2, g)
    res, ov = res.float().contiguous(), ov.float().contiguous()
    w2 = w.float().contiguous()
    csr, occ_r, occ_o = apec_union_worklist(res, ov, g, occupancy)
    sums = torch.empty((res.shape[0], n), dtype=torch.float32,
                       device=s.device)
    _csr.apec_matmul_csr(res, ov, w2, g, csr, occ_r, occ_o, route=route[0:1],
                         out=sums)
    occ_ov = _group_occupancy(occupancy, g, s2.shape[0])
    if occ_ov is None:
        occ_ov = padded_occupancy(ov, tile, tile)
    psum_ov = torch.zeros((ov.shape[0], n), dtype=torch.float32,
                          device=s.device)
    _csr.spike_matmul_pred(ov, w2, occ_ov.to(torch.int32).contiguous(),
                           route=route[1:2], out=psum_ov)
    _csr.spike_matmul_pred(res, w2, occupancy.to(torch.int32).contiguous(),
                           route=route[1:2], out=sums)
    out = sums + psum_ov.repeat_interleave(g, 0)
    return out.reshape(lead + (p, n)).to(w.dtype)


# ----------------------------------------------------------------- guard
def guard_repair(payload: torch.Tensor, w: torch.Tensor,
                 support: torch.Tensor, flag: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """The guard's trusted route for a call on a card map
    (`dispatch.use_guard("repair")`): kernel 10 on the payload alone,
    (..., K) spikes (words already unpacked) times (K, N), gated by
    `support`, the payload's exact tile map (`support_map`), and launched
    behind `flag` (one int32 on the card, set where the carried map failed
    the audit). Where the flag is set the product replaces `out`, the
    (..., N) output of the call on the carried map; elsewhere `out` comes
    back unchanged. An f32 contiguous `out` is written in place."""
    n = w.shape[-1]
    s2 = payload.reshape(-1, payload.shape[-1]).float().contiguous()
    w2 = w.float().contiguous()
    occ = support.to(torch.int32).contiguous()
    if out.dtype == torch.float32 and out.is_contiguous():
        _csr.spike_matmul_pred(s2, w2, occ, route=flag, out=out.view(-1, n))
        return out
    fixed = torch.empty((s2.shape[0], n), dtype=torch.float32,
                        device=out.device)
    _csr.spike_matmul_pred(s2, w2, occ, route=flag, out=fixed)
    return torch.where(flag.bool(), fixed.reshape(out.shape).to(out.dtype),
                       out)
