"""Convolutions of the SPS stem: the dense TConv oracle and the
registry-routed event convolution (im2col + CSR spike matmul on CUDA).

Layout: NHWC activations, HWIO weights; SAME pads follow lax's
convention (the smaller half first).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def conv_pads(size: int, k: int, stride: int, padding: str):
    """(out_size, pad_lo, pad_hi) matching lax's SAME/VALID conventions."""
    if padding == "SAME":
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        return out, total // 2, total - total // 2
    if padding == "VALID":
        return (size - k) // stride + 1, 0, 0
    raise ValueError(f"unsupported padding {padding!r}")


def pad_nchw(x: torch.Tensor, kh: int, kw: int, stride: int,
             padding: str) -> torch.Tensor:
    """Zero-pad an NCHW tensor so a VALID window pass equals lax's
    `padding` (SAME pads may be asymmetric, which F.conv2d cannot say)."""
    _, pt, pb = conv_pads(x.shape[2], kh, stride, padding)
    _, pl, pr = conv_pads(x.shape[3], kw, stride, padding)
    return F.pad(x, (pl, pr, pt, pb))


@contextlib.contextmanager
def _fp32_convolutions():
    """cuDNN's TF32 off for the calls inside (restored after): TF32 keeps
    ~3 decimal digits and would move spikes that sit near the threshold."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _FP32Conv2d(torch.autograd.Function):
    """`F.conv2d` (NCHW, no padding) whose forward AND backward run in full
    fp32: autograd's own conv backward would run after the flag is
    restored, in TF32."""

    @staticmethod
    def forward(ctx, x, wt, stride):
        ctx.save_for_backward(x, wt)
        ctx.stride = stride
        with _fp32_convolutions():
            return F.conv2d(x, wt, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, wt = ctx.saved_tensors
        dx = dw = None
        with _fp32_convolutions():
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv2d_input(x.shape, wt, g,
                                                stride=ctx.stride)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv2d_weight(x, wt.shape, g,
                                                 stride=ctx.stride)
        return dx, dw, None


def tconv(s: torch.Tensor, w: torch.Tensor, stride: int = 1,
          padding: str = "SAME") -> torch.Tensor:
    """TConv oracle. s: (N,H,W,Ci); w: (kh,kw,Ci,Co) -> (N,Ho,Wo,Co).

    A dense convolution in full fp32, forward and backward (cuDNN's TF32
    is switched off around both)."""
    kh, kw = w.shape[:2]
    x = pad_nchw(s.to(w.dtype).permute(0, 3, 1, 2), kh, kw, stride, padding)
    out = _FP32Conv2d.apply(x, w.permute(3, 2, 0, 1), stride)
    return out.permute(0, 2, 3, 1).contiguous()


def econv(s, w: torch.Tensor, stride: int = 1,
          padding: str = "SAME") -> torch.Tensor:
    """Event convolution routed through the backend registry. `s` may be
    an `EventTensor`: its carried map is propagated through the im2col
    window so the event kernel skips the patch-matrix pre-pass."""
    from repro_torch.kernels import dispatch
    return dispatch.econv(s, w, stride=stride, padding=padding)
