"""APEC overlap/residual extraction on packed spike words.

`apec_decompose_packed(s_packed, g)` takes (P, dw) uint32 words and
returns (overlap (P/g, dw), residual (P, dw)): overlap = AND over each
group of g adjacent rows, residual_i = s_i AND NOT overlap (Fig. 5's
compression step). On a CUDA tensor it launches `csrc/apec.cu`; on a CPU
tensor it runs the plain version. Any dw is taken as it is (the kernel
covers a ragged last vector), so the caller pads nothing beyond the
packing's own 32-bit words.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import apec_decompose_packed_ref

apec_decompose_packed_plain = apec_decompose_packed_ref   # AND, AND-NOT


def apec_decompose_packed(s_packed: torch.Tensor, g: int = 2):
    """(P, dw) uint32 words -> (overlap (P/g, dw), residual (P, dw))
    uint32 words. P must divide by g."""
    if s_packed.ndim != 2:
        raise ValueError(f"apec_decompose_packed needs (P, dw) words, got "
                         f"{tuple(s_packed.shape)}")
    p, dw = s_packed.shape
    if g < 1 or p % g:
        raise ValueError(f"positions {p} not divisible by group {g}")
    if not s_packed.is_cuda:
        return apec_decompose_packed_plain(s_packed, g)
    _build.require_cuda("apec_decompose", s_packed, dtype=torch.uint32)
    ov = torch.empty((p // g, dw), dtype=torch.uint32, device=s_packed.device)
    res = torch.empty_like(s_packed)
    lib = _build.library()
    _build.LAUNCHES["apec_decompose"] += 1
    _build.check(lib.apec_decompose_forward(
        s_packed.data_ptr(), ov.data_ptr(), res.data_ptr(), p, dw, g,
        _build.stream()), "apec_decompose")
    return ov, res
