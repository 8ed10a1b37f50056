"""Recurrent-state blocks, the port of `repro.models.ssm`: Mamba (jamba's
hybrid) and xLSTM (mLSTM / sLSTM), with the reference's names, params and
states.

These families carry O(d * d_state) recurrent state instead of a KV
cache. In spiking mode the LM fires their inputs through LIF, so the
block's matmuls see binary activations. The reference's recurrences are
`jax.lax.scan` over plain `jnp` (no Pallas kernel); here they are plain
PyTorch loops over time, one step function per family, written op for op
as the reference's: in bf16 the mLSTM and sLSTM agree bit for bit with
the reference run op by op (`jax.disable_jit()`), and Mamba within one
bf16 ulp, since a bf16 GEMM sums its f32 terms in another order than
XLA's dot and a sum within an f32 ulp of a bf16 midpoint rounds apart.

Each scan step rounds its output to bf16, whatever the dtype of the
params (`repro/models/ssm.py:68`, `:155`, `:241`): the recurrence runs in
f32, the stacked per-step outputs are bf16. So even with f32 trees a
block's output carries bf16 steps, and a one-ulp f32 difference in a
reduction's order (XLA's and PyTorch's sum in other orders) can move a
whole bf16 step: f32 parity holds within 2^-8 of max|ref|, not 1e-5.

Decode states are position-free: the recurrences fold each token into
fixed-shape carries. Under the slot-pool layout (`models/lm.py`
`init_decode_state`) every state leaf is stacked ``(n_groups, n_slots,
...)``: `*_state_init(b, ...)` is called with b = n_slots, and the slot
surgery addresses leaves by that contract. The recurrent states are f32,
except Mamba's conv window, which is bf16; the mLSTM and sLSTM
stabilisers `m` start at -1e30.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from .layers import _draw_device, dense_init, rmsnorm, rmsnorm_init


def _normal(shape: tuple, scale: float, dtype, generator: torch.Generator,
            device) -> torch.Tensor:
    """Standard normal draws in f32 times `scale`, in `dtype` on `device`
    (shapes only on `meta`)."""
    dev = resolve_device(device)
    w = torch.empty(shape, dtype=torch.float32,
                    device=_draw_device(generator, dev))
    w.normal_(generator=generator)
    return (w * scale).to(dev, dtype)


# =============================================================== Mamba (S6)
class MambaState(NamedTuple):
    h: torch.Tensor        # (B, d_inner, d_state) f32
    conv: torch.Tensor     # (B, d_conv - 1, d_inner) bf16 rolling window


def mamba_init(d_model: int, d_state: int = 16, d_conv: int = 4,
               expand: int = 2, dt_rank: Optional[int] = None,
               dtype=torch.bfloat16, *, generator: torch.Generator,
               device="cuda") -> dict:
    """bf16 projections and conv taps, f32 `a_log` (log 1..d_state on
    every channel) and `d_skip` (ones). dt_rank defaults to
    max(16, d_model // 16): 512 at jamba's d 8192."""
    d_inner = expand * d_model
    dt_rank = dt_rank or max(16, d_model // 16)
    dev = resolve_device(device)
    kw = dict(generator=generator, device=dev)
    return {
        "in_proj": dense_init(d_model, 2 * d_inner, dtype, **kw),
        "conv_w": _normal((d_conv, d_inner), 0.1, dtype, **kw),
        "x_proj": dense_init(d_inner, dt_rank + 2 * d_state, dtype, **kw),
        "dt_proj": dense_init(dt_rank, d_inner, dtype, **kw),
        "a_log": torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32, device=dev)[None]
            .repeat(d_inner, 1)),
        "d_skip": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(d_inner, d_model, dtype, **kw),
    }


def _mamba_scan_step(h: torch.Tensor, inputs, a: torch.Tensor):
    """One selective-SSM step on h (B, d_inner, d_state) f32. The inputs
    x_t, B_t, C_t arrive in the stream's dtype and dt_t in f32; the
    recurrence runs in f32 and the step's output is rounded to bf16."""
    xt, dt, bt, ct = inputs      # (B, di), (B, di) f32, (B, ds) x2
    xt32, bt32, ct32 = (t.float() for t in (xt, bt, ct))
    da = torch.exp(dt[..., None] * a[None])                 # (B, di, ds)
    h = h * da + dt[..., None] * xt32[..., None] * bt32[:, None, :]
    y = torch.einsum("bds,bs->bd", h, ct32)
    return h, y.to(torch.bfloat16)


def mamba_apply(p: dict, x: torch.Tensor,
                state: Optional[MambaState] = None, d_state: int = 16,
                d_conv: int = 4):
    """x (B, N, D) -> (out (B, N, D), new state). Without a state the
    conv history and h start at zero. The new conv window is the last
    d_conv - 1 rows of [history; x's conv inputs]."""
    b, n, d = x.shape
    d_inner = p["in_proj"].shape[-1] // 2
    dt_rank = p["x_proj"].shape[-1] - 2 * d_state

    xz = x @ p["in_proj"].to(x.dtype)
    xs, z = xz.split(d_inner, dim=-1)                        # (B, N, di)

    # Depthwise causal conv (window d_conv) over the carried history.
    if state is None:
        hist = xs.new_zeros((b, d_conv - 1, d_inner))
        h = torch.zeros((b, d_inner, d_state), dtype=torch.float32,
                        device=x.device)
    else:
        hist, h = state.conv.to(xs.dtype), state.h
    xpad = torch.cat([hist, xs], dim=1)                      # (B, N+c-1, di)
    windows = xpad.unfold(1, d_conv, 1).transpose(-1, -2)    # (B, N, c, di)
    xc = torch.einsum("bncd,cd->bnd", windows, p["conv_w"].to(xs.dtype))
    xc = F.silu(xc.float()).to(xs.dtype)

    proj = xc @ p["x_proj"].to(xc.dtype)
    dt, bmat, cmat = proj.split([dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus((dt @ p["dt_proj"].to(dt.dtype)).float())
    a = -torch.exp(p["a_log"])                               # (di, ds)

    ys = []
    for t in range(n):
        h, y_t = _mamba_scan_step(
            h, (xc[:, t], dt[:, t], bmat[:, t], cmat[:, t]), a)
        ys.append(y_t)
    y = torch.stack(ys, dim=1) + xc * p["d_skip"].to(xc.dtype)  # (B,N,di)
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = y @ p["out_proj"].to(y.dtype)
    return out, MambaState(h=h, conv=xpad[:, n:].to(torch.bfloat16))


def mamba_state_init(b: int, d_model: int, d_state: int = 16,
                     d_conv: int = 4, expand: int = 2,
                     device="cuda") -> MambaState:
    d_inner = expand * d_model
    dev = resolve_device(device)
    return MambaState(
        h=torch.zeros((b, d_inner, d_state), dtype=torch.float32,
                      device=dev),
        conv=torch.zeros((b, d_conv - 1, d_inner), dtype=torch.bfloat16,
                         device=dev))


# ================================================================== mLSTM
class MLSTMState(NamedTuple):
    c: torch.Tensor    # (B, H, dh, dh) matrix memory
    n: torch.Tensor    # (B, H, dh) normaliser
    m: torch.Tensor    # (B, H) stabiliser


def mlstm_init(d_model: int, n_heads: int, dtype=torch.bfloat16, *,
               generator: torch.Generator, device="cuda") -> dict:
    dh = d_model // n_heads
    kw = dict(generator=generator, device=device)
    p = {"norm": rmsnorm_init(d_model, device)}
    for name, d_out in (("w_q", d_model), ("w_k", d_model),
                        ("w_v", d_model), ("w_i", n_heads),
                        ("w_f", n_heads), ("w_o", d_model)):
        p[name] = dense_init(d_model, d_out, dtype, **kw)
    p["out_norm"] = rmsnorm_init(dh, device)
    return p


def _mlstm_step(state: MLSTMState, inp):
    """One matrix-memory step: q, k, v (B, H, dh) and the raw gates
    (B, H), all f32; the output (B, H, dh) rounded to bf16."""
    q, k, v, i_raw, f_raw = inp
    c, n, m = state
    m_new = torch.maximum(f_raw + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_raw + m - m_new)
    c = f_g[..., None, None] * c + i_g[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, c)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", q, n).abs(), min=1.0)
    return MLSTMState(c, n, m_new), (num / den[..., None]).to(torch.bfloat16)


def mlstm_apply(p: dict, x: torch.Tensor, n_heads: int,
                state: Optional[MLSTMState] = None):
    """mLSTM block: x (B, N, D) -> (x + its output, new state)."""
    b, nn, d = x.shape
    dh = d // n_heads
    xh = rmsnorm(p["norm"], x)

    def heads(w):
        return (xh @ w.to(xh.dtype)).reshape(b, nn, n_heads, dh).float()
    q, k, v = heads(p["w_q"]) / (dh ** 0.5), heads(p["w_k"]), heads(p["w_v"])
    i_raw = (xh @ p["w_i"].to(xh.dtype)).float()
    f_raw = F.logsigmoid((xh @ p["w_f"].to(xh.dtype)).float())

    if state is None:
        state = mlstm_state_init(b, d, n_heads, device=x.device)
    ys = []
    for t in range(nn):
        state, y_t = _mlstm_step(state, (q[:, t], k[:, t], v[:, t],
                                         i_raw[:, t], f_raw[:, t]))
        ys.append(y_t)
    y = torch.stack(ys, dim=1)                               # (B, N, H, dh)
    y = rmsnorm(p["out_norm"], y).reshape(b, nn, d).to(x.dtype)
    return x + y @ p["w_o"].to(x.dtype), state


def mlstm_state_init(b: int, d_model: int, n_heads: int,
                     device="cuda") -> MLSTMState:
    dh = d_model // n_heads
    dev = resolve_device(device)
    return MLSTMState(
        c=torch.zeros((b, n_heads, dh, dh), dtype=torch.float32, device=dev),
        n=torch.zeros((b, n_heads, dh), dtype=torch.float32, device=dev),
        m=torch.full((b, n_heads), -1e30, dtype=torch.float32, device=dev))


# ================================================================== sLSTM
class SLSTMState(NamedTuple):
    c: torch.Tensor    # (B, D)
    n: torch.Tensor    # (B, D)
    h: torch.Tensor    # (B, D)
    m: torch.Tensor    # (B, D)


def slstm_init(d_model: int, n_heads: int, dtype=torch.bfloat16, *,
               generator: torch.Generator, device="cuda") -> dict:
    """Input projections and block-diagonal recurrent weights (one
    (dh, dh) block a head, normal / sqrt(dh))."""
    dh = d_model // n_heads
    kw = dict(generator=generator, device=device)
    p = {"norm": rmsnorm_init(d_model, device)}
    for name in ("w_i", "w_f", "w_z", "w_o"):
        p[name] = dense_init(d_model, d_model, dtype, **kw)
    for name in ("r_i", "r_f", "r_z", "r_o"):
        p[name] = _normal((n_heads, dh, dh), 1.0 / dh ** 0.5, dtype, **kw)
    p["w_out"] = dense_init(d_model, d_model, dtype, **kw)
    return p


def _slstm_step(state: SLSTMState, inp, rec: dict, n_heads: int):
    """One scalar-memory step on the pre-activations (B, D) f32 each;
    `rec` holds the recurrent blocks in f32. The output h is rounded to
    bf16."""
    xi, xf, xz, xo = inp
    c, n, h, m = state
    b, d = h.shape
    hh = h.reshape(b, n_heads, d // n_heads)

    def rmul(r):
        return torch.einsum("bhd,hde->bhe", hh, r).reshape(b, d)
    i_raw = xi + rmul(rec["r_i"])
    f_raw = xf + rmul(rec["r_f"])
    z = torch.tanh(xz + rmul(rec["r_z"]))
    o = torch.sigmoid(xo + rmul(rec["r_o"]))
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    h = o * c / torch.clamp(n, min=1.0)
    return SLSTMState(c, n, h, m_new), h.to(torch.bfloat16)


def slstm_apply(p: dict, x: torch.Tensor, n_heads: int,
                state: Optional[SLSTMState] = None):
    """sLSTM block: x (B, N, D) -> (x + its output, new state)."""
    b, nn, d = x.shape
    xh = rmsnorm(p["norm"], x)
    pre = [(xh @ p[w].to(xh.dtype)).float()
           for w in ("w_i", "w_f", "w_z", "w_o")]
    rec = {r: p[r].float() for r in ("r_i", "r_f", "r_z", "r_o")}
    if state is None:
        state = slstm_state_init(b, d, device=x.device)
    hs = []
    for t in range(nn):
        state, h_t = _slstm_step(state, tuple(u[:, t] for u in pre), rec,
                                 n_heads)
        hs.append(h_t)
    y = torch.stack(hs, dim=1).to(x.dtype)
    return x + y @ p["w_out"].to(x.dtype), state


def slstm_state_init(b: int, d_model: int, device="cuda") -> SLSTMState:
    dev = resolve_device(device)

    def z():
        return torch.zeros((b, d_model), dtype=torch.float32, device=dev)
    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((b, d_model), -1e30, dtype=torch.float32,
                                   device=dev))
