"""Spike-driven self-attention (OR form), its causal (LM) form, and the
TPU rows' word functions, on the two SDSA kernels.

Spike entries (the registry's `sdsa` / `causal_sdsa` route on the card):
`sdsa_or_spikes(q, k, v)` takes (..., N, d) f32 or bf16 spikes and returns
(Q != 0 AND OR over N of (K != 0 AND V != 0)) as ones and zeros in q's
dtype; `causal_sdsa_spikes(q, k, v)` takes (T, ..., N, d) and ORs over
the micro-steps T and the tokens j <= i. Any strides, as long as d is the
unit-stride axis (the models pass head-transposed views); the output is
laid out like q (`torch.empty_like`), so the callers' transpose back is a
view.

Word entries (the TPU rows' own functions, held by chip_smoke (b) and
(k1)): `sdsa_packed(q, k, v)` on (BH, N, dw) uint32 words returns Q AND
(OR over N of K AND V); `sdsa_causal_status(kv)` returns the prefix-OR
over the token axis of (BH, N, dw) kv words.

On a CUDA tensor each entry makes one launch of its kernel
(`csrc/sdsa.cu` counts as `sdsa_or`, `csrc/sdsa_causal.cu` as
`sdsa_causal`) and raises on what the kernel cannot take; on a CPU tensor
it runs its plain version. The spikes are read where they lie: nothing is
packed, padded, copied or unpacked around the kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import sdsa_causal_status_ref, sdsa_packed_ref

# The kernels' block geometry (csrc/sdsa_units.cuh, csrc/sdsa_causal.cu;
# tests/test_torch_sdsa.py reads them back from the sources).
THREADS = 256             # kThreads
MAX_UNIT_BLOCK = 64       # kMaxUnitBlock: units a block spans across a row
CAUSAL_TOKENS = 8         # kTok: consecutive tokens a causal thread scans
OR_MIN_TOKENS = 4         # tokens an OR-form token group reads at least
KIND = {torch.float32: 0, torch.bfloat16: 1, torch.uint32: 2}

sdsa_packed_plain = sdsa_packed_ref   # plain version: AND, OR tree, AND
sdsa_causal_status_plain = sdsa_causal_status_ref   # doubling OR scan


def sdsa_or_spikes_plain(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Plain version of `sdsa_or_spikes`: `any` over N."""
    status = ((k != 0) & (v != 0)).any(dim=-2, keepdim=True)
    return ((q != 0) & status).to(q.dtype)


def causal_sdsa_spikes_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """Plain version of `causal_sdsa_spikes`: the T-fold, then a
    cumulative OR over N (`cummax` of the 0/1 mask)."""
    kv = ((k != 0) & (v != 0)).any(dim=0)
    status = kv.to(torch.uint8).cummax(dim=-2).values.bool()
    return ((q != 0) & status).to(q.dtype)


def unit_block(units: int) -> int:
    """Units a block spans across a row: the largest power of two up to
    MAX_UNIT_BLOCK whose slices of the row leave at most an eighth of
    their threads without a unit."""
    ub = MAX_UNIT_BLOCK
    while ub > 1 and -(-units // ub) * ub * 8 > units * 9:
        ub //= 2
    return ub


def or_groups(ub: int, n: int) -> int:
    """Token groups of an OR-form block: THREADS // ub, halved while a
    group would read fewer than OR_MIN_TOKENS tokens (short rows share a
    block instead)."""
    groups = THREADS // ub
    while groups > 1 and groups * OR_MIN_TOKENS > n:
        groups //= 2
    return groups


def causal_plan(rows: int, n: int, units: int) -> dict:
    """The causal kernel's grid: `ub` units a block, `lanes` token lanes of
    CAUSAL_TOKENS tokens, so a chunk of `chunk` tokens; `chunks` chunks
    per (row, slice), linked by the look-back when more than one."""
    ub = unit_block(units)
    lanes = THREADS // ub
    chunk = lanes * CAUSAL_TOKENS
    slices = -(-units // ub)
    return dict(ub=ub, lanes=lanes, chunk=chunk, slices=slices,
                chunks=-(-n // chunk), blocks=rows * slices * -(-n // chunk))


def look_back_words(rows: int, slices: int, chunks: int, ub: int) -> int:
    """int64 words of the look-back's flags ((rows x slices, chunks, ub)
    64-bit flags, then (rows x slices, ub) 32-bit counters); 0 for one
    chunk."""
    if chunks <= 1:
        return 0
    return rows * slices * chunks * ub + -(-rows * slices * ub // 2)


_FLAGS: dict = {}
_KEPT_FLAGS = 16


def _flags(device: torch.device, words: int) -> torch.Tensor | None:
    """Zeroed look-back flags for a launch on the current stream. The
    kernel leaves every flag and counter it used zero again, so a buffer
    is zeroed once and kept for its (device, stream, capture): eager
    calls share one a stream; a CUDA graph capture gets its own, zeroed
    by a fill the graph captures (once a replay, whatever the number of
    launches in it)."""
    if words == 0:
        return None
    stream = _build.stream()
    capture = ctypes.c_uint64(0)
    if torch.cuda.is_current_stream_capturing():
        _build.check(_build.library().sdsa_capture_id(
            stream, ctypes.addressof(capture)), "sdsa_capture_id")
    key = (device, stream, capture.value)
    buf = _FLAGS.pop(key, None)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 1 << 14), dtype=torch.int64,
                          device=device)
    _FLAGS[key] = buf                # newest last; the oldest go first
    while len(_FLAGS) > _KEPT_FLAGS:
        del _FLAGS[next(iter(_FLAGS))]
    return buf


def _check_spikes(name: str, *xs: torch.Tensor, min_ndim: int) -> None:
    q = xs[0]
    if any(x.shape != q.shape for x in xs) or q.ndim < min_ndim:
        raise ValueError(f"{name} needs equal operands of at least "
                         f"{min_ndim} axes, got "
                         f"{[tuple(x.shape) for x in xs]}")


def _require_card(name: str, *xs: torch.Tensor) -> None:
    """What the spike entries take on the card: one CUDA device, one dtype
    (f32 or bf16), nothing autograd records."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            f"{name}: the kernel would cut the autograd graph; call it "
            f"through repro_torch.kernels.dispatch, or under no_grad")
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"{name}: all operands must be on one CUDA device, "
                         f"got {[str(x.device) for x in xs]}")
    if any(x.dtype != xs[0].dtype for x in xs) or \
            xs[0].dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: operands must all be float32 or all "
                         f"bfloat16, got {[x.dtype for x in xs]}")


def _describe(ops, causal: bool):
    """The kernels' descriptor of operands (q, k, v, out), one shape:
    (vec, units, [t, r1, r2, r3, n, c, then per operand st, s1, s2, s3,
    sn]) in elements. Leading axes laid out right behind the channels
    (the heads of a head-transposed view) join the channel axis; adjacent
    leading axes laid out as one merge; at most three stay."""
    shape = ops[0].shape
    strides = [x.stride() for x in ops]
    n, c = shape[-2], shape[-1]
    if c > 1 and any(s[-1] != 1 for s in strides):
        raise ValueError("SDSA kernels need a unit-stride channel axis, got "
                         f"strides {strides}")
    first = 1 if causal else 0
    lead = [(shape[i], [s[i] for s in strides])
            for i in range(first, len(shape) - 2) if shape[i] != 1]
    joined = True
    while joined:
        joined = False
        for i, (size, st) in enumerate(lead):
            if all(s == c for s in st):
                c *= size
                del lead[i]
                joined = True
                break
    merged: list = []
    for size, st in lead:
        if merged and all(p == size * s for p, s in zip(merged[-1][1], st)):
            merged[-1] = (merged[-1][0] * size, st)
        else:
            merged.append((size, st))
    if len(merged) > 3:
        raise ValueError(f"SDSA kernels take at most three leading axes "
                         f"that do not merge, got strides {strides}")
    merged = [(1, [0] * 4)] * (3 - len(merged)) + merged
    t = shape[0] if causal else 1
    st = [s[0] for s in strides] if causal else [0] * 4
    sn = [s[-2] for s in strides]
    itemsize = ops[0].element_size()
    elems = 16 // itemsize
    per_op = [[st[o], *(m[1][o] for m in merged), sn[o]] for o in range(4)]
    vec = ops[0].dtype != torch.uint32 and c % elems == 0 and all(
        x % elems == 0 for row in per_op for x in row) and all(
        x.data_ptr() % 16 == 0 for x in ops)
    units = c // elems if vec else c
    return vec, units, [t, *(m[0] for m in merged), n, c,
                        *(x for row in per_op for x in row)]


_PREPARED: dict = {}
_KEPT_LAYOUTS = 256


def _prepared(causal: bool, words: bool, q, k, v, out):
    """(descriptor address, descriptor, look-back flag words) of these
    operands, built once a layout: the shape, every stride, each base's
    16-byte alignment (the vector path) and the dtype decide them. The
    word status entry describes its (BH, N, dw) words as T = 1."""
    key = (causal, words, out.dtype, out.shape, q.stride(), k.stride(),
           v.stride(), out.stride(), q.data_ptr() % 16, k.data_ptr() % 16,
           v.data_ptr() % 16, out.data_ptr() % 16)
    hit = _PREPARED.get(key)
    if hit is None:
        ops = (q, k, v, out)
        vec, units, layout = _describe(
            tuple(x[None] for x in ops) if words else ops, causal)
        rows, n = math.prod(layout[1:4]), layout[4]
        if causal:
            plan = causal_plan(rows, n, units)
            ub, value = plan["ub"], plan["chunk"]
            flag_words = look_back_words(rows, plan["slices"],
                                         plan["chunks"], ub)
        else:
            ub = unit_block(units)
            value, flag_words = or_groups(ub, n), 0
        desc = (ctypes.c_int64 * (4 + len(layout)))(
            KIND[k.dtype], int(vec), ub, value, *layout)
        hit = (ctypes.addressof(desc), desc, flag_words)
        if len(_PREPARED) >= _KEPT_LAYOUTS:
            _PREPARED.clear()
        _PREPARED[key] = hit
    return hit


def _launch(causal: bool, q, k, v, out, words: bool = False,
            lib=None) -> torch.Tensor:
    """One launch of csrc/sdsa_causal.cu (`causal`) or csrc/sdsa.cu into
    `out` (`lib`: another build of them, for tools/stream_probe.py)."""
    addr, _, flag_words = _prepared(causal, words, q, k, v, out)
    lib = lib or _build.library()
    if causal:
        flags = _flags(out.device, flag_words)
        _build.LAUNCHES["sdsa_causal"] += 1
        _build.check(lib.sdsa_causal_strided_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), addr,
            None if flags is None else flags.data_ptr(), _build.stream()),
            "sdsa_causal")
    else:
        _build.LAUNCHES["sdsa_or"] += 1
        _build.check(lib.sdsa_or_strided_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), addr,
            _build.stream()), "sdsa_or")
    return out


def sdsa_or_spikes(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """(..., N, d) f32 / bf16 spikes x3 -> (..., N, d) in q's dtype and
    layout: Q AND (OR over N of K AND V)."""
    _check_spikes("sdsa_or_spikes", q, k, v, min_ndim=2)
    if not q.is_cuda:
        return sdsa_or_spikes_plain(q, k, v)
    _require_card("sdsa_or", q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    return _launch(False, q, k, v, out)


def causal_sdsa_spikes(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """(T, ..., N, d) f32 / bf16 spikes x3 -> (T, ..., N, d) in q's dtype
    and layout: out[t, i] = Q[t, i] AND (OR over T and tokens j <= i of K
    AND V). Any N."""
    _check_spikes("causal_sdsa_spikes", q, k, v, min_ndim=3)
    if not q.is_cuda:
        return causal_sdsa_spikes_plain(q, k, v)
    _require_card("sdsa_causal", q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    return _launch(True, q, k, v, out)


def sdsa_packed(q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """(BH, N, dw) uint32 words x3 -> (BH, N, dw) uint32 words."""
    if q.shape != k.shape or q.shape != v.shape or q.ndim != 3:
        raise ValueError(f"sdsa_packed needs three equal (BH, N, dw) "
                         f"operands, got {q.shape}, {k.shape}, {v.shape}")
    if not q.is_cuda:
        return sdsa_packed_plain(q, k, v)
    _build.require_cuda("sdsa_or", q, k, v, dtype=torch.uint32)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    return _launch(False, q, k, v, out)


def sdsa_causal_status(kv: torch.Tensor) -> torch.Tensor:
    """(BH, N, dw) uint32 kv words -> (BH, N, dw) uint32: out[b, i] = OR
    over tokens j <= i of kv[b, j]. Any N (no padding to a block)."""
    if kv.ndim != 3 or kv.dtype != torch.uint32:
        raise ValueError(f"sdsa_causal_status needs (BH, N, dw) uint32 "
                         f"words, got {tuple(kv.shape)} {kv.dtype}")
    if not kv.is_cuda:
        return sdsa_causal_status_plain(kv)
    _build.require_cuda("sdsa_causal", kv, dtype=torch.uint32)
    out = torch.empty_like(kv)
    if out.numel() == 0:
        return out
    # The word kind reads the kv words as k and writes the status.
    return _launch(True, kv, kv, kv, out, words=True)
