"""Convolutions (OPT2, Algorithm 1 lines 5-16): the dense TConv oracle,
the registry-routed event convolution (im2col + CSR spike matmul on
CUDA), the faithful per-event scatter form, and the segmentation
decoder's transposed convolution.

  tconv            dense fp32 conv, the TConv baseline and `econv`'s oracle
  econv_scatter    Algorithm 1 as written: extract AER events (y, x, ci)
                   and scatter-add each event's weight patch into the
                   output (`index_add_` over all events at once)
  econv            registry op: im2col + an occupancy-skipping matmul
  conv_transpose   registry op `tconv`: the decoder's upsampling conv;
                   zero-insertion keeps events binary, so its kernel form
                   is im2col + the predicated spike matmul

Layout: NHWC activations, HWIO weights; SAME pads follow lax's
convention (the smaller half first).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

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


def extract_events(s: torch.Tensor,
                   max_events: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """AER extraction: indices of active spikes in an (H, W, Ci) map.

    Returns (idx (max_events, 3) int32 rows [h, w, ci], valid
    (max_events,) bool), events in row-major order. `max_events` is the
    static capacity (H*W*Ci worst case); unused slots are index 0 and
    invalid, and events past the capacity are dropped, as
    `jnp.nonzero(size=...)` drops them.
    """
    (lin,) = torch.nonzero(s.reshape(-1), as_tuple=True)
    lin = lin[:max_events]
    valid = torch.zeros(max_events, dtype=torch.bool, device=s.device)
    valid[:lin.numel()] = True
    lin_c = torch.zeros(max_events, dtype=torch.int64, device=s.device)
    lin_c[:lin.numel()] = lin
    idx = torch.stack(torch.unravel_index(lin_c, tuple(s.shape)), dim=-1)
    return idx.to(torch.int32), valid


def econv_scatter(s: torch.Tensor, w: torch.Tensor,
                  max_events: Optional[int] = None) -> torch.Tensor:
    """Event-driven convolution by per-event weight scatter (stride 1,
    SAME). s: (N,H,W,Ci) binary; w: (kh,kw,Ci,Co).

    Each event (h, w, ci) adds the spatially flipped weight patch
    w[::-1, ::-1, ci, :] into out[h - kh//2 : ..., w - kw//2 : ..., :], the
    "fixed spatial influence range" of Fig. 1(b), all C_o channels at
    once. Every event of every image (the first `max_events` per image)
    lands in one `index_add_`; the values are the weights, not the spike
    magnitudes, so the form is exact for binary inputs only.
    """
    n, hh, ww, ci = s.shape
    kh, kw, _, co = w.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("econv_scatter supports odd kernels (paper uses 3x3)")
    if max_events is None:
        max_events = hh * ww * ci
    hp, wp = hh + kh - 1, ww + kw - 1
    img, lin = torch.nonzero(s.reshape(n, -1), as_tuple=True)
    # Rank of each event inside its image (nonzero is row-major, so each
    # image's events are contiguous and in AER order): keep the first
    # `max_events`, as the per-image FIFO of the faithful form does.
    first = torch.searchsorted(img, img, right=False)
    keep = (torch.arange(img.numel(), device=s.device) - first) < max_events
    img, lin = img[keep], lin[keep]
    y, x, c = torch.unravel_index(lin, (hh, ww, ci))
    dy, dx = torch.meshgrid(torch.arange(kh, device=s.device),
                            torch.arange(kw, device=s.device), indexing="ij")
    # Event at (y, x) lands on padded out[y + dy, x + dx] with w[-1-dy,
    # -1-dx]: the flipped patch over the (kh, kw) window at (y, x).
    target = ((img[:, None] * hp + y[:, None] + dy.reshape(1, -1)) * wp +
              x[:, None] + dx.reshape(1, -1))
    w_flip = w.flip(0, 1).reshape(kh * kw, ci, co).float()
    vals = w_flip[:, c, :].transpose(0, 1)                 # (E, kh*kw, Co)
    out = torch.zeros(n * hp * wp, co, dtype=torch.float32, device=s.device)
    out.index_add_(0, target.reshape(-1), vals.reshape(-1, co))
    out = out.reshape(n, hp, wp, co)
    return out[:, kh // 2:kh // 2 + hh, kw // 2:kw // 2 + ww, :]


def econv_gather(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense event-form: the per-position accumulation of Algorithm 1,
    vectorized, a mid-level oracle between tconv and the scatter. Equal
    to tconv for stride 1 / SAME."""
    return tconv(s, w, 1, "SAME")


def event_ops(s: torch.Tensor, co: int, k: int) -> torch.Tensor:
    """EConv accumulation count: n_events * C_o * k^2 (paper Sec. III-A2)."""
    return torch.sum(s.to(torch.int64)) * co * k * k


def tconv_ops(h: int, w: int, ci: int, co: int, k: int) -> int:
    """TConv MAC count: H*W*k^2*Ci*Co (dense, sparsity-independent)."""
    return h * w * k * k * ci * co


# ------------------------------------------------- transposed convolution
class _FP32ConvTranspose2d(torch.autograd.Function):
    """`F.conv_transpose2d` (NCHW, no padding, full output) whose forward
    and backward run in full fp32, as `_FP32Conv2d`: the input cotangent
    is the strided conv of g, the weight cotangent conv2d's weight
    gradient with the roles of input and output swapped."""

    @staticmethod
    def forward(ctx, x, wt, stride):
        ctx.save_for_backward(x, wt)
        ctx.stride = stride
        with _fp32_convolutions():
            return F.conv_transpose2d(x, wt, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, wt = ctx.saved_tensors
        dx = dw = None
        with _fp32_convolutions():
            if ctx.needs_input_grad[0]:
                dx = F.conv2d(g, wt, stride=ctx.stride)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv2d_weight(g, wt.shape, x,
                                                 stride=ctx.stride)
        return dx, dw, None


def _conv_transpose_pads(k: int, stride: int, padding: str):
    """lax.conv_transpose's padding arithmetic: the (lo, hi) pads of the
    zero-inserted input that make a stride-1 VALID conv equal the
    transposed conv."""
    if padding == "SAME":
        pad_len = k + stride - 2
        pad_a = k - 1 if stride > k - 1 else int(math.ceil(pad_len / 2))
    elif padding == "VALID":
        pad_len = k + stride - 2 + max(k - stride, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"unsupported padding {padding!r}")
    return pad_a, pad_len - pad_a


def conv_transpose_ref(s: torch.Tensor, w: torch.Tensor, stride: int = 2,
                       padding: str = "SAME") -> torch.Tensor:
    """Transposed-conv oracle (the `ref` backend of the `tconv` op), with
    lax.conv_transpose's semantics (kernel not transposed). s: (N,H,W,Ci);
    w: (kh,kw,Ci,Co) -> (N, H*stride, W*stride, Co) for SAME.

    PyTorch's transposed conv flips the kernel and yields the full
    (H-1)*stride + k output; lax's pads (lo, hi) pick the window starting
    k-1-lo into it and reaching hi-(k-1) past it (zeros where hi > k-1).
    Full fp32 in forward and backward (cuDNN's TF32 off around both)."""
    kh, kw = w.shape[:2]
    (pa, pb), (pc, pd) = (_conv_transpose_pads(k, stride, padding)
                          for k in (kh, kw))
    x = s.to(w.dtype).permute(0, 3, 1, 2)
    full = _FP32ConvTranspose2d.apply(x, w.flip(0, 1).permute(2, 3, 0, 1),
                                      stride)
    out = F.pad(full, (pc - (kw - 1), pd - (kw - 1),
                       pa - (kh - 1), pb - (kh - 1)))
    return out.permute(0, 2, 3, 1).contiguous()


def upsample_events(s: torch.Tensor, stride: int, kh: int, kw: int,
                    padding: str) -> torch.Tensor:
    """Zero-insert + pad so a stride-1 VALID conv equals the transposed
    conv: events keep their binarity, only their spatial addresses dilate
    (the event-driven view of fractional striding)."""
    n, h, w_, ci = s.shape
    up = s.new_zeros((n, (h - 1) * stride + 1, (w_ - 1) * stride + 1, ci))
    up[:, ::stride, ::stride] = s
    (pa, pb), (pc, pd) = (_conv_transpose_pads(k, stride, padding)
                          for k in (kh, kw))
    return F.pad(up, (0, 0, pc, pd, pa, pb))


def conv_transpose_upsampled(s: torch.Tensor, w: torch.Tensor,
                             stride: int = 2,
                             padding: str = "SAME") -> torch.Tensor:
    """`jnp` backend of `tconv`: explicit zero-insertion, then a plain
    stride-1 VALID conv; the same linear map as the oracle, and the
    intermediate stays binary for binary inputs."""
    up = upsample_events(s, stride, w.shape[0], w.shape[1], padding)
    return tconv(up, w, 1, "VALID")


def conv_transpose(s, w: torch.Tensor, stride: int = 2,
                   padding: str = "SAME") -> torch.Tensor:
    """Transposed conv routed through the backend registry (`tconv` op).
    An `EventTensor` input loses its map here: zero-insertion dilates the
    event addresses (the documented invalidation rule)."""
    from repro_torch.kernels import dispatch
    return dispatch.tconv(s, w, stride=stride, padding=padding)
