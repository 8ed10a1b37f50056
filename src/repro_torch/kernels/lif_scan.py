"""Fused temporal LIF scan: CUDA kernel wrappers and their plain versions.

`lif` fires a (T, P) drive; `lif_counts` fires a (T, R, K) drive and also
emits the int32 event count of every (t, 8-row chunk, 128-lane tile), the
layout of `repro`'s `_lif_occ_pallas`. On a CUDA tensor each wrapper
launches `csrc/lif.cu`; on a CPU tensor it runs the plain version.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import lif_scan_ref

CHUNK = 8      # row chunk of the count map
LANES = 128    # lane tile of the count map


lif_plain = lif_scan_ref   # plain version: the core loop over T


def chunk_counts(s: torch.Tensor) -> torch.Tensor:
    """(T, R, K) spikes -> (T, R/8, ceil(K/128)) int32 event counts per
    (t, 8-row chunk, 128-lane tile). Lanes past K count as silent."""
    t, r, k = s.shape
    pad = (-k) % LANES
    if pad:
        s = torch.nn.functional.pad(s, (0, pad))
    blocks = s.reshape(t, r // CHUNK, CHUNK, -1, LANES)
    return (blocks != 0).sum(dim=(2, 4), dtype=torch.int32)


def lif_counts_plain(x: torch.Tensor, *, decay: float = 0.5,
                     v_th: float = 1.0, soft_reset: bool = True):
    """Plain version of the counts mode: fire, then count per chunk."""
    s = lif_plain(x, decay=decay, v_th=v_th, soft_reset=soft_reset)
    return s, chunk_counts(s)


def lif(x: torch.Tensor, *, decay: float = 0.5, v_th: float = 1.0,
        soft_reset: bool = True) -> torch.Tensor:
    """x: (T, ...) f32 drive -> spikes of the same shape."""
    if not x.is_cuda:
        return lif_plain(x, decay=decay, v_th=v_th, soft_reset=soft_reset)
    _build.require_cuda("lif", x, dtype=torch.float32)
    s = torch.empty_like(x)
    t = x.shape[0]
    p = x.numel() // t if t else 0
    lib = _build.library()
    _build.LAUNCHES["lif"] += 1
    _build.check(lib.lif_forward(x.data_ptr(), s.data_ptr(), t, p,
                                 float(decay), float(v_th), int(soft_reset),
                                 _build.stream()), "lif")
    return s


def lif_counts(x: torch.Tensor, *, decay: float = 0.5, v_th: float = 1.0,
               soft_reset: bool = True):
    """x: (T, R, K) f32 drive with R % 8 == 0 -> (spikes (T, R, K),
    counts (T, R/8, ceil(K/128)) int32)."""
    if x.ndim != 3 or x.shape[1] % CHUNK:
        raise ValueError(f"lif_counts needs (T, R, K) with R % {CHUNK} == 0, "
                         f"got {tuple(x.shape)}")
    if not x.is_cuda:
        return lif_counts_plain(x, decay=decay, v_th=v_th,
                                soft_reset=soft_reset)
    _build.require_cuda("lif_counts", x, dtype=torch.float32)
    t, r, k = x.shape
    s = torch.empty_like(x)
    counts = torch.empty((t, r // CHUNK, -(-k // LANES)), dtype=torch.int32,
                         device=x.device)
    lib = _build.library()
    _build.LAUNCHES["lif_counts"] += 1
    _build.check(lib.lif_counts_forward(
        x.data_ptr(), s.data_ptr(), counts.data_ptr(), t, r, k, float(decay),
        float(v_th), int(soft_reset), _build.stream()), "lif_counts")
    return s, counts
