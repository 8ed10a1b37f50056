"""APEC overlap/residual extraction (Fig. 5's compression step): for each
group of g adjacent rows, overlap = AND of the rows, residual_i = s_i AND
NOT overlap. Both entries run one template of `csrc/apec.cu`.

Spike entry (the dense APEC route's): `apec_decompose_spikes(s, g)` takes
(P, C) f32 or bf16 spikes, read where they lie (unit channel stride, any
row stride, so a caller's `reshape(-1, C)` view needs no copy), and
returns (overlap (P/g, C), residual (P, C)) as ones and zeros in s's
dtype; a spike is `s != 0`, as `pack_spikes` reads it.

Word entry (the TPU row's own function): `apec_decompose_packed(s_packed,
g)` takes (P, dw) uint32 words and returns (overlap (P/g, dw), residual
(P, dw)) words. Any dw is taken as it is (the kernel covers a ragged last
vector), so the caller pads nothing beyond the packing's own words.

On a CUDA tensor each entry makes one launch (counted as
`apec_decompose_spikes` / `apec_decompose`) and raises on what the kernel
cannot take; on a CPU tensor it runs its plain version.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import apec_decompose_packed_ref

apec_decompose_packed_plain = apec_decompose_packed_ref   # AND, AND-NOT

# Spike dtypes the spike entry takes on the card -> the kernel's kind.
KIND = {torch.float32: 0, torch.bfloat16: 1}


def _check_groups(p: int, g: int) -> None:
    if g < 1 or p % g:
        raise ValueError(f"positions {p} not divisible by group {g}")


def apec_decompose_spikes_plain(s: torch.Tensor, g: int):
    """Plain version of `apec_decompose_spikes`: `s != 0` grouped, `all`
    over each group, AND-NOT, cast to s's dtype."""
    p, c = s.shape
    grp = (s != 0).reshape(p // g, g, c)
    ov = grp.all(dim=1)
    res = grp & ~ov[:, None, :]
    return ov.to(s.dtype), res.reshape(p, c).to(s.dtype)


def _require_card(s: torch.Tensor) -> int:
    """What the spike entry takes on the card -> the kernel's kind: f32 or
    bf16 spikes whose channel axis is unit-stride, nothing autograd
    records."""
    if torch.is_grad_enabled() and s.requires_grad:
        raise RuntimeError(
            "apec_decompose_spikes: the kernel would cut the autograd graph; "
            "call it through repro_torch.kernels.dispatch, or under no_grad")
    if s.dtype not in KIND:
        raise ValueError(f"apec_decompose_spikes takes float32 or bfloat16 "
                         f"spikes on the card, got {s.dtype}")
    if s.shape[1] > 1 and s.stride(1) != 1:
        raise ValueError(f"apec_decompose_spikes needs a unit-stride channel "
                         f"axis, got strides {s.stride()}")
    return KIND[s.dtype]


def apec_decompose_spikes(s: torch.Tensor, g: int = 2):
    """(P, C) spikes -> (overlap (P/g, C), residual (P, C)) in s's dtype,
    ones and zeros. P must divide by g."""
    if s.ndim != 2:
        raise ValueError(f"apec_decompose_spikes needs (P, C) spikes, got "
                         f"{tuple(s.shape)}")
    p, c = s.shape
    _check_groups(p, g)
    if not s.is_cuda:
        return apec_decompose_spikes_plain(s, g)
    kind = _require_card(s)
    ov = torch.empty((p // g, c), dtype=s.dtype, device=s.device)
    res = torch.empty((p, c), dtype=s.dtype, device=s.device)
    if p == 0 or c == 0:
        return ov, res
    lib = _build.library()
    _build.LAUNCHES["apec_decompose_spikes"] += 1
    _build.check(lib.apec_decompose_spikes_forward(
        s.data_ptr(), ov.data_ptr(), res.data_ptr(), p, c,
        s.stride(0) if p > 1 else c, g, kind, _build.stream()),
        "apec_decompose_spikes")
    return ov, res


def apec_decompose_packed(s_packed: torch.Tensor, g: int = 2):
    """(P, dw) uint32 words -> (overlap (P/g, dw), residual (P, dw))
    uint32 words. P must divide by g."""
    if s_packed.ndim != 2:
        raise ValueError(f"apec_decompose_packed needs (P, dw) words, got "
                         f"{tuple(s_packed.shape)}")
    p, dw = s_packed.shape
    _check_groups(p, g)
    if not s_packed.is_cuda:
        return apec_decompose_packed_plain(s_packed, g)
    _build.require_cuda("apec_decompose", s_packed, dtype=torch.uint32)
    ov = torch.empty((p // g, dw), dtype=torch.uint32, device=s_packed.device)
    res = torch.empty_like(s_packed)
    if p == 0 or dw == 0:
        return ov, res
    lib = _build.library()
    _build.LAUNCHES["apec_decompose"] += 1
    _build.check(lib.apec_decompose_forward(
        s_packed.data_ptr(), ov.data_ptr(), res.data_ptr(), p, dw, g,
        _build.stream()), "apec_decompose")
    return ov, res
