"""Fused temporal LIF scan: CUDA kernel wrappers and their plain versions.

`lif` fires a (T, P) drive, f32 or bf16 (bf16 spikes out, the membrane
kept in f32, as `repro`'s `_lif_kernel` reads `x.dtype`); `lif_counts` fires a (T, R, K) drive and also
emits the int32 event count of every (8-row chunk, 128-lane tile) of the
flattened (T*R, K) spikes (`repro`'s `_lif_occ_pallas` layout flattened,
for any R); `lif_counts_packed` emits the same
counts with the spikes as uint32 words (T, R, ceil(K/32)) and no f32
spike tensor, forward only (`repro`'s `lif_scan_occ_packed_pallas`).
`lif_fwd` (f32 or bf16, as `lif`) and `lif_counts_fwd` are
the same with the pre-reset membrane residual `vres` (T, ...) f32 added,
and `lif_bwd(vres, g)` is the reversed-time ATan surrogate backward (g and
dx f32 or bf16, the membrane cotangent carried in f32). On a
CUDA tensor each wrapper launches `csrc/lif.cu`; on a CPU tensor it runs
its plain version.

`LIFScanSG` and `LIFScanOccSG` are the differentiable fires (the port of
`lif_scan_pallas_sg` / `lif_scan_occ_pallas_sg`): their `run` takes the
residual kernel and records the surrogate backward only while autograd
records the drive, and takes the primal kernel otherwise, so inference
pays nothing for differentiability.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.spikes import pack_spikes_padded
from repro_torch.core.surrogate import atan_surrogate
from . import _build

CHUNK = 8      # row chunk of the count map
LANES = 128    # lane tile of the count map
WORD_VECS = 8          # 4-lane vectors a uint32 word (csrc/lif.cu kWordVecs)
COUNT_THREADS = 256    # the most threads a counts block holds (kCountThreads)
COUNTS_MODES = {"lif_counts": 0, "lif_counts_packed": 1, "lif_counts_fwd": 2}


def chunk_counts(s: torch.Tensor) -> torch.Tensor:
    """(T, R, K) spikes -> (ceil(T*R/8), ceil(K/128)) int32 event counts
    per (8-row chunk, 128-lane tile) of the flattened (T*R, K) rows. Rows
    past T*R and lanes past K count as silent."""
    s = s.reshape(-1, s.shape[-1])
    s = torch.nn.functional.pad(s, (0, (-s.shape[1]) % LANES,
                                    0, (-s.shape[0]) % CHUNK))
    blocks = s.reshape(-1, CHUNK, s.shape[1] // LANES, LANES)
    return (blocks != 0).sum(dim=(1, 3), dtype=torch.int32)


def counts_layout(k: int) -> dict:
    """`csrc/lif.cu`'s `counts_layout` for K lanes: a thread owns one
    4-lane vector of one row; `slots`, the threads a row takes in a lane
    tile (the tile's vectors rounded up to whole 8-vector word groups
    from 32 lanes on, to a power of two below); `chunks`, the 8-row
    chunks a block holds; `threads` a block; `kt` lane tiles."""
    v, tile_vecs = -(-k // 4), LANES // 4
    if v >= tile_vecs:
        slots = tile_vecs
    elif v >= WORD_VECS:
        slots = -(-v // WORD_VECS) * WORD_VECS
    else:
        slots = 1 << (v - 1).bit_length()
    chunks = max(1, COUNT_THREADS // (CHUNK * slots))
    return {"slots": slots, "chunks": chunks,
            "threads": CHUNK * chunks * slots, "kt": -(-k // LANES)}


def counts_launch(rows: int, k: int, name: str = "lif_counts") -> dict:
    """The launch the counts kernel `name` makes for R rows of K lanes, as
    its C library reports it: the layout, the grid (every block an SM
    holds on every SM, or one block an item), its items, and the share of
    a block's threads whose lanes all lie past K. Needs a card."""
    got = (ctypes.c_int * 7)()
    _build.check(_build.library().lif_counts_launch(
        rows, k, COUNTS_MODES[name], got), "lif_counts_launch")
    slots, chunks, threads, kt, grid, sms, per_sm = got
    items = -(-rows // (CHUNK * chunks)) * kt
    live = sum(min(slots, max(0, -(-(k - j * LANES) // 4)))
               for j in range(kt))
    return {"slots": slots, "chunks": chunks, "threads": threads, "kt": kt,
            "grid": grid, "items": items, "sms": sms, "blocks_per_sm": per_sm,
            "idle_lane_share": 1 - live / (kt * slots)}


# ------------------------------------------------------ plain versions
def lif_fwd_plain(x: torch.Tensor, *, decay: float = 0.5, v_th: float = 1.0,
                  soft_reset: bool = True):
    """Plain version of the residual mode: the kernel's step, op by op, in
    its order -> (spikes in the drive's dtype, pre-reset membrane vres
    f32). A bf16 drive is widened exactly and the membrane kept in f32,
    as `repro`'s `_lif_fwd_kernel` keeps it in its f32 scratch."""
    xf = x.float()
    v = torch.zeros_like(xf[0])
    s = torch.empty_like(x)
    vres = torch.empty_like(xf)
    for t in range(x.shape[0]):
        v = decay * v + xf[t]
        vres[t] = v
        st = (v >= v_th).float()
        s[t] = st
        v = v - st * v_th if soft_reset else v * (1.0 - st)
    return s, vres


def lif_plain(x: torch.Tensor, *, decay: float = 0.5, v_th: float = 1.0,
              soft_reset: bool = True) -> torch.Tensor:
    """The kernel's step in f32 (a bf16 drive widened exactly), spikes
    returned in the drive's dtype."""
    return lif_fwd_plain(x, decay=decay, v_th=v_th, soft_reset=soft_reset)[0]


def lif_counts_fwd_plain(x: torch.Tensor, *, decay: float = 0.5,
                         v_th: float = 1.0, soft_reset: bool = True):
    """Plain version of the counts + residual mode: fire, then count per
    chunk -> (spikes, counts, vres)."""
    s, vres = lif_fwd_plain(x, decay=decay, v_th=v_th, soft_reset=soft_reset)
    return s, chunk_counts(s), vres


def lif_counts_plain(x: torch.Tensor, *, decay: float = 0.5,
                     v_th: float = 1.0, soft_reset: bool = True):
    """Plain version of the counts mode: fire, then count per chunk."""
    s = lif_plain(x, decay=decay, v_th=v_th, soft_reset=soft_reset)
    return s, chunk_counts(s)


def lif_counts_packed_plain(x: torch.Tensor, *, decay: float = 0.5,
                            v_th: float = 1.0, soft_reset: bool = True):
    """Plain version of the packed mode: fire, pack the spikes (pad bits
    zero), count per chunk -> (words, counts)."""
    s, counts = lif_counts_plain(x, decay=decay, v_th=v_th,
                                 soft_reset=soft_reset)
    return pack_spikes_padded(s), counts


def lif_bwd_plain(vres: torch.Tensor, g: torch.Tensor, *, decay: float = 0.5,
                  v_th: float = 1.0, soft_reset: bool = True,
                  surrogate_alpha: float = 2.0) -> torch.Tensor:
    """Plain version of the backward: the kernel's reversed scan, op by op
    in its order (`repro/kernels/lif_scan.py:107-138`). The membrane
    cotangent `u` is carried in f32 (a bf16 g widened exactly) and each
    step's dx rounded once to g's dtype, as the TPU kernel does."""
    gf = g.float()
    dx = torch.empty_like(g)
    u = torch.zeros_like(gf[0])
    for t in reversed(range(g.shape[0])):
        v = vres[t].float()
        sg = atan_surrogate(v - v_th, surrogate_alpha)
        if soft_reset:
            dreset = 1.0 - v_th * sg
        else:
            dreset = (1.0 - (v >= v_th).float()) - v * sg
        dv = gf[t] * sg + u * dreset
        dx[t] = dv
        u = decay * dv
    return dx


# ------------------------------------------------------------ wrappers
def _flat(x: torch.Tensor):
    t = x.shape[0]
    return t, (x.numel() // t if t else 0)


def _check_counts_shape(name: str, x: torch.Tensor) -> None:
    if x.ndim != 3:
        raise ValueError(f"{name} needs a (T, R, K) drive, got "
                         f"{tuple(x.shape)}")


def _counts_out(x: torch.Tensor) -> torch.Tensor:
    """The kernel's count map for a (T, R, K) drive; zeroed when R is
    ragged, where the kernel adds into it."""
    t, r, k = x.shape
    shape = (-(-t * r // CHUNK), -(-k // LANES))
    alloc = torch.zeros if r % CHUNK else torch.empty
    return alloc(shape, dtype=torch.int32, device=x.device)


def lif(x: torch.Tensor, *, decay: float = 0.5, v_th: float = 1.0,
        soft_reset: bool = True) -> torch.Tensor:
    """x: (T, ...) f32 or bf16 drive -> spikes of the same shape and dtype.
    bf16 drives launch the bf16 instance of the kernel, counted apart as
    ``lif_bf16``."""
    if not x.is_cuda:
        return lif_plain(x, decay=decay, v_th=v_th, soft_reset=soft_reset)
    bf16 = x.dtype == torch.bfloat16
    name = "lif_bf16" if bf16 else "lif"
    _build.require_cuda(name, x, dtype=torch.bfloat16 if bf16
                        else torch.float32)
    s = torch.empty_like(x)
    t, p = _flat(x)
    lib = _build.library()
    entry = lib.lif_bf16_forward if bf16 else lib.lif_forward
    _build.LAUNCHES[name] += 1
    _build.check(entry(x.data_ptr(), s.data_ptr(), t, p, float(decay),
                       float(v_th), int(soft_reset), _build.stream()), name)
    return s


def lif_fwd(x: torch.Tensor, *, decay: float = 0.5, v_th: float = 1.0,
            soft_reset: bool = True):
    """x: (T, ...) f32 or bf16 drive -> (spikes in x's dtype, pre-reset
    membrane vres f32). bf16 drives launch the bf16 instance, counted
    apart as ``lif_fwd_bf16``."""
    if not x.is_cuda:
        return lif_fwd_plain(x, decay=decay, v_th=v_th, soft_reset=soft_reset)
    bf16 = x.dtype == torch.bfloat16
    name = "lif_fwd_bf16" if bf16 else "lif_fwd"
    _build.require_cuda(name, x, dtype=torch.bfloat16 if bf16
                        else torch.float32)
    s = torch.empty_like(x)
    vres = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    t, p = _flat(x)
    lib = _build.library()
    entry = lib.lif_fwd_bf16_forward if bf16 else lib.lif_fwd_forward
    _build.LAUNCHES[name] += 1
    _build.check(entry(x.data_ptr(), s.data_ptr(), vres.data_ptr(), t, p,
                       float(decay), float(v_th), int(soft_reset),
                       _build.stream()), name)
    return s, vres


def lif_counts(x: torch.Tensor, *, decay: float = 0.5, v_th: float = 1.0,
               soft_reset: bool = True):
    """x: (T, R, K) f32 drive -> (spikes (T, R, K), counts
    (ceil(T*R/8), ceil(K/128)) int32 over the flattened rows)."""
    _check_counts_shape("lif_counts", x)
    if not x.is_cuda:
        return lif_counts_plain(x, decay=decay, v_th=v_th,
                                soft_reset=soft_reset)
    _build.require_cuda("lif_counts", x, dtype=torch.float32)
    t, r, k = x.shape
    s = torch.empty_like(x)
    counts = _counts_out(x)
    lib = _build.library()
    _build.LAUNCHES["lif_counts"] += 1
    _build.check(lib.lif_counts_forward(
        x.data_ptr(), s.data_ptr(), counts.data_ptr(), t, r, k, float(decay),
        float(v_th), int(soft_reset), _build.stream()), "lif_counts")
    return s, counts


def lif_counts_packed(x: torch.Tensor, *, decay: float = 0.5,
                      v_th: float = 1.0, soft_reset: bool = True):
    """x: (T, R, K) f32 drive -> (words (T, R, ceil(K/32)) uint32, counts
    (ceil(T*R/8), ceil(K/128)) int32). Forward only."""
    _check_counts_shape("lif_counts_packed", x)
    if not x.is_cuda:
        return lif_counts_packed_plain(x, decay=decay, v_th=v_th,
                                       soft_reset=soft_reset)
    _build.require_cuda("lif_counts_packed", x, dtype=torch.float32)
    t, r, k = x.shape
    words = torch.empty((t, r, -(-k // 32)), dtype=torch.uint32,
                        device=x.device)
    counts = _counts_out(x)
    lib = _build.library()
    _build.LAUNCHES["lif_counts_packed"] += 1
    _build.check(lib.lif_counts_packed_forward(
        x.data_ptr(), words.data_ptr(), counts.data_ptr(), t, r, k,
        float(decay), float(v_th), int(soft_reset), _build.stream()),
        "lif_counts_packed")
    return words, counts


def lif_counts_fwd(x: torch.Tensor, *, decay: float = 0.5, v_th: float = 1.0,
                   soft_reset: bool = True):
    """`lif_counts` plus the residual: -> (spikes, counts, vres f32)."""
    _check_counts_shape("lif_counts_fwd", x)
    if not x.is_cuda:
        return lif_counts_fwd_plain(x, decay=decay, v_th=v_th,
                                    soft_reset=soft_reset)
    _build.require_cuda("lif_counts_fwd", x, dtype=torch.float32)
    t, r, k = x.shape
    s = torch.empty_like(x)
    vres = torch.empty_like(x)
    counts = _counts_out(x)
    lib = _build.library()
    _build.LAUNCHES["lif_counts_fwd"] += 1
    _build.check(lib.lif_counts_fwd_forward(
        x.data_ptr(), s.data_ptr(), counts.data_ptr(), vres.data_ptr(), t, r,
        k, float(decay), float(v_th), int(soft_reset), _build.stream()),
        "lif_counts_fwd")
    return s, counts, vres


def lif_bwd(vres: torch.Tensor, g: torch.Tensor, *, decay: float = 0.5,
            v_th: float = 1.0, soft_reset: bool = True,
            surrogate_alpha: float = 2.0) -> torch.Tensor:
    """vres: (T, ...) f32, g: (T, ...) f32 or bf16 -> dx, the drive's
    cotangent in g's dtype. A bf16 g launches the bf16 instance (u in f32,
    dx rounded once), counted apart as ``lif_bwd_bf16``."""
    if vres.shape != g.shape:
        raise ValueError(f"lif_bwd: vres {tuple(vres.shape)} and g "
                         f"{tuple(g.shape)} differ")
    if not g.is_cuda:
        return lif_bwd_plain(vres, g, decay=decay, v_th=v_th,
                             soft_reset=soft_reset,
                             surrogate_alpha=surrogate_alpha)
    bf16 = g.dtype == torch.bfloat16
    name = "lif_bwd_bf16" if bf16 else "lif_bwd"
    _build.require_cuda(name, vres, g)
    if vres.dtype != torch.float32 or not (bf16 or g.dtype == torch.float32):
        raise ValueError(f"{name}: expected f32 vres and f32 or bf16 g, got "
                         f"{vres.dtype} and {g.dtype}")
    dx = torch.empty_like(g)
    t, p = _flat(g)
    lib = _build.library()
    entry = lib.lif_bf16_backward if bf16 else lib.lif_backward
    _build.LAUNCHES[name] += 1
    _build.check(entry(
        vres.data_ptr(), g.data_ptr(), dx.data_ptr(), t, p, float(decay),
        float(v_th), int(soft_reset), surrogate_alpha / 2.0,
        0.5 * math.pi * surrogate_alpha, _build.stream()), name)
    return dx


# ------------------------------------------------- differentiable fires
def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _surrogate_backward(ctx, g):
    (vres,) = ctx.saved_tensors
    return lif_bwd(vres, g.contiguous(), **ctx.cfg), None, None, None, None


class LIFScanSG(torch.autograd.Function):
    """Differentiable fire of a (T, ...) drive: the residual kernel
    forward, the surrogate kernel backward. Call `LIFScanSG.run`."""

    @staticmethod
    def forward(ctx, x, decay, v_th, soft_reset, surrogate_alpha):
        s, vres = lif_fwd(x, decay=decay, v_th=v_th, soft_reset=soft_reset)
        ctx.save_for_backward(vres)
        ctx.cfg = dict(decay=decay, v_th=v_th, soft_reset=soft_reset,
                       surrogate_alpha=surrogate_alpha)
        return s

    @staticmethod
    def backward(ctx, g):
        return _surrogate_backward(ctx, g)

    @staticmethod
    def run(x: torch.Tensor, *, decay: float = 0.5, v_th: float = 1.0,
            soft_reset: bool = True,
            surrogate_alpha: float = 2.0) -> torch.Tensor:
        if _records(x):
            return LIFScanSG.apply(x, decay, v_th, soft_reset,
                                   surrogate_alpha)
        return lif(x, decay=decay, v_th=v_th, soft_reset=soft_reset)


class LIFScanOccSG(torch.autograd.Function):
    """`LIFScanSG` with the chunk counts: (spikes, counts); the counts are
    metadata and carry no gradient. Call `LIFScanOccSG.run`."""

    @staticmethod
    def forward(ctx, x, decay, v_th, soft_reset, surrogate_alpha):
        s, counts, vres = lif_counts_fwd(x, decay=decay, v_th=v_th,
                                         soft_reset=soft_reset)
        ctx.save_for_backward(vres)
        ctx.mark_non_differentiable(counts)
        ctx.cfg = dict(decay=decay, v_th=v_th, soft_reset=soft_reset,
                       surrogate_alpha=surrogate_alpha)
        return s, counts

    @staticmethod
    def backward(ctx, g, g_counts):
        del g_counts                 # the counts carry no gradient
        return _surrogate_backward(ctx, g)

    @staticmethod
    def run(x: torch.Tensor, *, decay: float = 0.5, v_th: float = 1.0,
            soft_reset: bool = True, surrogate_alpha: float = 2.0):
        if _records(x):
            return LIFScanOccSG.apply(x, decay, v_th, soft_reset,
                                      surrogate_alpha)
        return lif_counts(x, decay=decay, v_th=v_th, soft_reset=soft_reset)
