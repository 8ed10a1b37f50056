"""Backend dispatch registry for the SpikingFormer and CNN hot-path ops.

Model code calls ops only through this registry; each op has a plain
PyTorch oracle (`ref`) and the hand-written CUDA kernels (`cuda`), plus
manual routes (`auto=False`, reached only by an override):

  op            backend      realization
  ------------  -----------  --------------------------------------------
  lif_scan      cuda         csrc/lif.cu, no-counts mode
  lif_scan_occ  cuda         csrc/lif.cu, counts mode (+ 16:1 map sum);
                             packed=True: its packed mode (words, no
                             spikes)
  spike_matmul  cuda         csrc/spike_matmul_csr.cu on the carried map
                cuda-packed  csrc/spike_matmul_csr.cu's word kernel
                             (packed payload)
                cuda-pred    csrc/spike_matmul.cu, predicated (manual)
  sdsa          cuda         csrc/sdsa.cu on packed words (mode="or")
  econv         cuda         im2col + csrc/spike_matmul_csr.cu
                cuda-packed  word-domain im2col + the word kernel
                             (packed payload)
                cuda-pred    im2col + csrc/spike_matmul.cu (manual)
                jnp          per-event scatter, `econv_scatter` (manual)
  tconv         cuda         zero-insertion + im2col + csrc/spike_matmul.cu
                jnp          zero-insertion + dense conv (manual)
  apec_matmul   cuda         csrc/apec.cu + csrc/apec_matmul_csr.cu (union
                             work list, both products in one pass)
                cuda-packed  csrc/apec.cu + csrc/apec_matmul_csr.cu's word
                             kernel (packed payload)
                cuda-pred    csrc/apec.cu + two csrc/spike_matmul.cu launches
                             (manual)
                jnp          overlap-reuse dense form, `core.apec` (auto on
                             every platform, above `ref`, as in `repro`)

(`tconv` is the transposed conv of SegNet's decoder; the dense forward
conv oracle of `econv` is `core.econv.tconv`, the paper's "TConv".)

Selection order per call:
  1. an explicit override — the `use_backend(...)` context or the
     ``EXSPIKE_BACKEND`` env var (``ref`` for all ops, or a comma list of
     ``op=backend`` entries). It runs the named backend on whatever
     device the tensors lie on: the kernel wrappers take their plain
     version for CPU tensors, which is how the CPU tests walk the kernel
     path;
  2. otherwise the highest-priority automatic (``auto=True``) backend
     registered for the platform of the call's first tensor (``cpu`` or
     ``cuda``) and for the call's payload.
A `supports` gate that refuses a call raises; the warn-and-degrade
chains of `repro`'s registry, and its mesh, hybrid and guard routing, are
not ported yet.

Payload routing (as in `repro`): a call whose spike operand is uint32
words carries the ``packed_k=`` kwarg (the logical channel count, threaded
from a packed `EventTensor`). Automatic selection takes it only to a
backend declaring ``payload=("packed",)`` and never takes a dense call
there. On the card a packed call lands on its packed kernel or raises;
on the CPU, which has no packed backend, it lands on `ref`. Wherever a
packed call reaches a dense backend (that `ref`, or an explicit
override), the words are unpacked by an explicit shim that warns once
and is attributed ``<backend>+unpack``.

Gradient contract (as in `repro`): every backend declares how autograd
goes through it, so training resolves backends exactly as inference does.
``differentiable=True``: autograd through `fn` itself gives the `ref`
oracle's (surrogate) gradients — the oracles, and the fire kernels, whose
`autograd.Function` runs the surrogate backward kernel. ``vjp="ref"``:
the backward replays `ref`'s autograd on the saved inputs (SDSA keeps the
tie splitting of `amax`; econv replays the dense conv). ``vjp=<rule>``:
an explicit ``(saved_args, static_kwargs, g) -> grads`` rule
(`_matmul_bwd`). Tensor kwargs (the carried `occupancy` map) are
metadata and get no gradient, and so are packed words: the weights'
gradients flow through the unpacked values.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.spikes import unpack_spikes_padded

ENV_VAR = "EXSPIKE_BACKEND"
REF = "ref"
CUDA = "cuda"
CUDA_PRED = "cuda-pred"
CUDA_PACKED = "cuda-packed"
ALL_PLATFORMS = ("cpu", "cuda")
PACKED_OPS = ("spike_matmul", "econv", "apec_matmul")   # take packed_k=


@dataclasses.dataclass(frozen=True)
class Backend:
    """One registered implementation of an op. `supports(*args, **kw)`
    returns a reason string when it cannot take the call (None: it can);
    `platforms` are the devices it is auto-selected on; an ``auto=False``
    backend is never auto-selected, only named by an override; `payload`
    names the spike payloads it is auto-selected for ("dense" f32 spikes,
    "packed" uint32 words)."""
    name: str
    fn: Callable
    platforms: Tuple[str, ...] = ALL_PLATFORMS
    priority: int = 0
    auto: bool = True
    supports: Optional[Callable[..., Optional[str]]] = None
    differentiable: bool = False
    payload: Tuple[str, ...] = ("dense",)

    def unsupported_reason(self, *args, **kwargs) -> Optional[str]:
        if self.supports is None:
            return None
        return self.supports(*args, **kwargs)


@dataclasses.dataclass
class OpSpec:
    name: str
    make_example: Callable[[torch.device], Tuple[tuple, dict]]
    backends: Dict[str, Backend] = dataclasses.field(default_factory=dict)


_REGISTRY: Dict[str, OpSpec] = {}
_OVERRIDES: list = []   # stack of {op_or_None: backend_name} dicts


# ----------------------------------------------------------- registration
def register_op(name: str, make_example) -> None:
    if name not in _REGISTRY:
        _REGISTRY[name] = OpSpec(name=name, make_example=make_example)


class _CustomVJP(torch.autograd.Function):
    """Runs a backend forward with autograd off and a declared rule
    backward: the `ref` oracle's replayed autograd or an explicit rule."""

    @staticmethod
    def forward(ctx, op, fn, rule, static, aux, *args):
        ctx.op, ctx.rule, ctx.static, ctx.aux = op, rule, static, aux
        ctx.save_for_backward(*args)
        return fn(*args, **static, **aux)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        if ctx.rule == REF:
            ref_fn = _REGISTRY[ctx.op].backends[REF].fn
            static = dict(ctx.static)
            pk = static.pop("packed_k", None)
            if pk is not None:           # replay on the unpacked words
                args = (unpack_spikes_padded(args[0], pk),) + tuple(args[1:])
            with torch.enable_grad():
                inputs = [a.detach().requires_grad_(need) for a, need in
                          zip(args, ctx.needs_input_grad[5:])]
                out = ref_fn(*inputs, **static, **ctx.aux)
                pulled = iter(torch.autograd.grad(
                    out, [a for a in inputs if a.requires_grad], g))
            grads = [next(pulled) if a.requires_grad else None
                     for a in inputs]
        else:
            grads = [d if need else None for d, need in zip(
                ctx.rule(args, ctx.static, g), ctx.needs_input_grad[5:])]
        return (None,) * 5 + tuple(grads)


def _wrap_vjp(op: str, fn, rule):
    """Make `fn` differentiable under a declared backward rule (see the
    module docstring). Tensor-valued kwargs are non-differentiated aux
    operands; the rest are static."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        aux = {k: v for k, v in kwargs.items()
               if isinstance(v, torch.Tensor)}
        static = {k: v for k, v in kwargs.items() if k not in aux}
        return _CustomVJP.apply(op, fn, rule, static, aux, *args)
    return wrapper


def _matmul_bwd(res, kwargs, g):
    """Transpose rule for `out = s @ w` with leading batch axes on s:
    ds = g @ w.T and dw = sum over rows of s^T g, in fp32 — the dense
    oracle's cotangents everywhere, also in the tiles the event walk
    skipped (autograd through the gated plain version would give ds = 0
    there). Packed words (``packed_k``) get no cotangent; dw comes from
    their unpacked values."""
    s, w = res
    gf = g.float()
    pk = kwargs.get("packed_k")
    if pk is not None:
        s = unpack_spikes_padded(s, pk)
        ds = None
    else:
        ds = torch.matmul(gf, w.float().T).to(s.dtype)
    dw = torch.matmul(s.reshape(-1, s.shape[-1]).float().T,
                      gf.reshape(-1, gf.shape[-1])).to(w.dtype)
    return ds, dw


def register(op: str, name: str, *, platforms=ALL_PLATFORMS, priority=0,
             auto=True, supports=None, differentiable=False, vjp=None,
             payload=("dense",)):
    """Decorator: register `fn` as backend `name` for `op`. ``auto=False``
    keeps it out of priority resolution: only `use_backend` or
    ``EXSPIKE_BACKEND`` reach it. ``payload=("packed",)`` makes it the
    automatic choice for packed-word calls (and never for dense ones).

    Gradient contract: ``differentiable=True`` when autograd through `fn`
    gives the `ref` oracle's gradients, or ``vjp="ref"`` /
    ``vjp=<rule>`` to wrap `fn` in a `torch.autograd.Function` (see
    `_wrap_vjp`); wrapped backends are differentiable by definition."""
    def deco(fn):
        if op not in _REGISTRY:
            raise KeyError(f"unknown op {op!r}; register_op it first")
        _REGISTRY[op].backends[name] = Backend(
            name=name, fn=_wrap_vjp(op, fn, vjp) if vjp is not None else fn,
            platforms=tuple(platforms), priority=priority, auto=auto,
            supports=supports, differentiable=differentiable or vjp is not None,
            payload=tuple(payload))
        return fn
    return deco


def op_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def backend_names(op: str) -> Tuple[str, ...]:
    return tuple(_REGISTRY[op].backends)


def differentiable_backend_names(op: str) -> Tuple[str, ...]:
    """Backends of `op` declaring the gradient contract."""
    return tuple(n for n, b in _REGISTRY[op].backends.items()
                 if b.differentiable)


def get_backend(op: str, name: str) -> Backend:
    try:
        return _REGISTRY[op].backends[name]
    except KeyError:
        raise KeyError(f"op {op!r} has no backend {name!r}; "
                       f"registered: {backend_names(op)}") from None


# -------------------------------------------------------------- overrides
@functools.lru_cache(maxsize=8)
def _parse_env(value: str) -> Tuple[Tuple[Optional[str], str], ...]:
    """'ref' -> ((None,'ref'),); 'sdsa=cuda,ref' -> per-op + global."""
    out = []
    for part in value.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            op, be = part.split("=", 1)
            out.append((op.strip(), be.strip()))
        else:
            out.append((None, part))
    return tuple(out)


def _override_for(op: str) -> Optional[str]:
    for frame in reversed(_OVERRIDES):
        if op in frame:
            return frame[op]
        if None in frame:
            return frame[None]
    env = os.environ.get(ENV_VAR, "")
    if env:
        glob = None
        for o, be in _parse_env(env):
            if o == op:
                return be
            if o is None:
                glob = be
        return glob
    return None


@contextlib.contextmanager
def use_backend(name: str, op: Optional[str] = None):
    """Force backend `name` for one op (or all ops when op=None)."""
    _OVERRIDES.append({op: name})
    try:
        yield
    finally:
        _OVERRIDES.pop()


# -------------------------------------------------------------- resolution
def _platform(args) -> str:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device.type
    raise TypeError("dispatch needs at least one tensor argument")


_WARNED: set = set()


def _unpack_shim(op: str, be: Backend) -> Backend:
    """`be` behind an explicit unpack of packed words: the words become the
    dense f32 spikes of their `packed_k` channels and the marker is
    consumed. Warns once per (op, backend); attributed ``+unpack``."""
    if (op, be.name) not in _WARNED:
        _WARNED.add((op, be.name))
        warnings.warn(f"exspike dispatch: packed payload for op {op!r} "
                      f"reaches the dense backend {be.name!r}; unpacking "
                      f"the words (explicit unpack shim)", RuntimeWarning,
                      stacklevel=4)

    @functools.wraps(be.fn)
    def fn(s, *rest, packed_k, **kw):
        return be.fn(unpack_spikes_padded(s, packed_k), *rest, **kw)
    return dataclasses.replace(be, fn=fn, name=f"{be.name}+unpack")


def resolve(op: str, *args, **kwargs) -> Backend:
    """The backend `dispatch` would run for these inputs."""
    spec = _REGISTRY[op]
    override = _override_for(op)
    packed = kwargs.get("packed_k") is not None
    if override is not None:
        be = get_backend(op, override)
    else:
        platform = _platform(args)
        want = "packed" if packed else "dense"
        be = max((b for b in spec.backends.values()
                  if b.auto and platform in b.platforms
                  and want in b.payload),
                 key=lambda b: b.priority, default=None)
        if be is None and packed and platform == "cpu":
            be = spec.backends[REF]          # no packed backend on the CPU
        if be is None:
            raise RuntimeError(f"op {op!r} has no {want}-payload backend "
                               f"for platform {platform!r}")
    reason = be.unsupported_reason(*args, **kwargs)
    if reason is not None:
        raise ValueError(f"backend {be.name!r} for op {op!r} cannot take "
                         f"this call: {reason}")
    if packed and "packed" not in be.payload:
        be = _unpack_shim(op, be)
    return be


def dispatch(op: str, *args, **kwargs):
    """Run `op` on the resolved backend."""
    return resolve(op, *args, **kwargs).fn(*args, **kwargs)


def _packed_example(op: str, dev):
    """`op`'s example inputs with the spike operand as packed words."""
    from repro_torch.core.spikes import pack_spikes_padded
    args, kwargs = _REGISTRY[op].make_example(dev)
    s = args[0]
    return ((pack_spikes_padded(s),) + tuple(args[1:]),
            {**kwargs, "packed_k": s.shape[-1]})


def resolved_backends(device="cuda", *, packed: bool = False
                      ) -> Dict[str, str]:
    """op -> name of the backend that would run each op's example inputs
    on `device` under the current overrides (startup log). ``packed``:
    the ops that take a packed payload (`PACKED_OPS`) are resolved on
    packed words, as a `SpikingConfig(packed=True)` forward calls them."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    out = {}
    for op, spec in _REGISTRY.items():
        if packed and op in PACKED_OPS:
            ex_args, ex_kwargs = _packed_example(op, dev)
        else:
            ex_args, ex_kwargs = spec.make_example(dev)
        out[op] = resolve(op, *ex_args, **ex_kwargs).name
    return out


def _binary(shape, p: float, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    return (torch.rand(shape, generator=g) < p).float().to(device)


# ======================================================================
# Op definitions + backend implementations
# ======================================================================
# ------------------------------------------------------------- lif_scan
register_op("lif_scan", lambda dev: (
    (2.0 * torch.randn(4, 3, 40, generator=torch.Generator().manual_seed(0))
     .to(dev),), {"decay": 0.5, "v_th": 1.0, "soft_reset": True}))


@register("lif_scan", REF, priority=0, differentiable=True)
def _lif_ref(x, **kwargs):
    from repro_torch.kernels.ref import lif_scan_ref
    return lif_scan_ref(x, **kwargs)


@register("lif_scan", CUDA, platforms=("cuda",), priority=20,
          differentiable=True)
def _lif_cuda(x, *, decay=0.5, v_th=1.0, soft_reset=True,
              surrogate_alpha=2.0):
    from repro_torch.kernels import ops
    return ops.lif(x, decay=decay, v_th=v_th, soft_reset=soft_reset,
                   surrogate_alpha=surrogate_alpha)


# --------------------------------------------------------- lif_scan_occ
# The full-event producer: fire AND emit the spikes' (128, 128) per-tile
# occupancy map plus its 8-row chunk refinement. Returns (spikes, map,
# chunks).
register_op("lif_scan_occ", lambda dev: (
    (2.0 * torch.randn(3, 8, 40, generator=torch.Generator().manual_seed(0))
     .to(dev),), {"decay": 0.5, "v_th": 1.0, "soft_reset": True}))


def _ref_chunk_occupancy(s):
    from repro_torch.core.spikes import tile_occupancy
    from repro_torch.kernels.ops import _pad_to
    s2, _ = _pad_to(s.reshape(-1, s.shape[-1]), 0, 128)
    s2, _ = _pad_to(s2, 1, 128)
    return tile_occupancy(s2, 8, 128)


@register("lif_scan_occ", REF, priority=0, differentiable=True)
def _lif_occ_ref(x, *, decay=0.5, v_th=1.0, soft_reset=True,
                 surrogate_alpha=2.0, packed=False):
    s = _lif_ref(x.detach() if packed else x, decay=decay, v_th=v_th,
                 soft_reset=soft_reset, surrogate_alpha=surrogate_alpha)
    # One chunk-granular pre-pass; the tile map is its 16:1 aggregation
    # (identical to the fused kernel's emission, counts and all).
    chunks = _ref_chunk_occupancy(s)
    occ = chunks.reshape(-1, 16, chunks.shape[1]).sum(dim=1,
                                                      dtype=torch.int32)
    if packed:
        # The forward-only packed emission, oracle form: fire, then pack.
        from repro_torch.core.spikes import pack_spikes_padded
        return pack_spikes_padded(s), occ, chunks
    return s, occ, chunks


def _lif_occ_supports(x, **kwargs) -> Optional[str]:
    del kwargs
    r = 1
    for d in x.shape[1:-1]:
        r *= d
    if r % 8:
        return (f"fused occupancy emission needs the middle axes to fill "
                f"8-row chunks, got R={r}")
    return None


@register("lif_scan_occ", CUDA, platforms=("cuda",), priority=20,
          supports=_lif_occ_supports, differentiable=True)
def _lif_occ_cuda(x, *, decay=0.5, v_th=1.0, soft_reset=True,
                  surrogate_alpha=2.0, packed=False):
    from repro_torch.kernels import ops
    return ops.lif_occ(x, decay=decay, v_th=v_th, soft_reset=soft_reset,
                       surrogate_alpha=surrogate_alpha, packed=packed)


# --------------------------------------------------------- spike_matmul
def _spike_matmul_example(dev):
    s = _binary((2, 48, 96), 0.3, dev)
    w = torch.randn(96, 56, generator=torch.Generator().manual_seed(1))
    return (s, w.to(dev)), {}


register_op("spike_matmul", _spike_matmul_example)


@register("spike_matmul", REF, priority=0, differentiable=True)
def _spike_matmul_ref(s, w, occupancy=None):
    del occupancy    # metadata for the event kernel; the oracle is dense
    from repro_torch.kernels.ref import spike_matmul_ref
    return spike_matmul_ref(s, w)


@register("spike_matmul", CUDA, platforms=("cuda",), priority=20,
          vjp=_matmul_bwd)
def _spike_matmul_csr(s, w, occupancy=None):
    # Event-compacted tile walk; a carried `occupancy` replaces the dense
    # pre-pass (the work list compacts from the small map).
    from repro_torch.kernels import ops
    return ops.spike_matmul_csr(s, w, occupancy=occupancy)


@register("spike_matmul", CUDA_PACKED, platforms=("cuda",), priority=30,
          vjp=_matmul_bwd, payload=("packed",))
def _spike_matmul_packed(s, w, occupancy=None, packed_k=None):
    # The CSR walk on packed words: each occupied word tile unpacks on
    # chip. Dense spikes (packed_k=None) are packed at entry.
    from repro_torch.kernels import ops
    return ops.spike_matmul_packed(s, w, packed_k=packed_k,
                                   occupancy=occupancy)


@register("spike_matmul", CUDA_PRED, auto=False, vjp=_matmul_bwd)
def _spike_matmul_pred(s, w, occupancy=None):
    # Predicated dense grid: every tile visited, the map gates the product.
    from repro_torch.kernels import ops
    return ops.spike_matmul(s, w, occupancy=occupancy)


# ---------------------------------------------------------- apec_matmul
def _apec_example(dev):
    s = _binary((2, 16, 48), 0.4, dev)
    w = torch.randn(48, 24, generator=torch.Generator().manual_seed(1))
    return (s, w.to(dev)), {"g": 2}


register_op("apec_matmul", _apec_example)


def _apec_divisibility(s, w, *, g=2, **kwargs) -> Optional[str]:
    del w, kwargs
    if s.shape[-2] % g:
        return f"positions {s.shape[-2]} not divisible by group {g}"
    return None


@register("apec_matmul", REF, priority=0, differentiable=True)
def _apec_matmul_ref(s, w, *, g=2, occupancy=None):
    del g, occupancy    # the oracle is the plain dense accumulation s @ w
    return torch.matmul(s.float(), w.float()).to(w.dtype)


# The overlap/residual decomposition equals s @ w in value but not under
# autodiff (amin would split cotangents between tied group members), so
# the explicit transpose rule supplies the exact gradients.
@register("apec_matmul", "jnp", priority=10, supports=_apec_divisibility,
          vjp=_matmul_bwd)
def _apec_matmul_jnp(s, w, *, g=2, occupancy=None):
    del occupancy       # the dense form gates on nothing
    from repro_torch.core.apec import apec_matmul_jnp
    return apec_matmul_jnp(s, w, g)


@register("apec_matmul", CUDA_PRED, auto=False, supports=_apec_divisibility,
          vjp=_matmul_bwd)
def _apec_matmul_pred(s, w, *, g=2, occupancy=None):
    # Packed decompose, then two predicated matmuls and a repeat.
    from repro_torch.kernels import ops
    return ops.apec_matmul(s, w, g=g, occupancy=occupancy)


def _apec_csr_supports(s, w, *, g=2, **kwargs) -> Optional[str]:
    # The fused kernel maps each output row tile onto a (128/g)-row
    # overlap tile, so g must divide the 128-row tile, and its overlap
    # accumulator gives each of 16 thread rows 8/g rows: g is 2, 4 or 8.
    del kwargs
    reason = _apec_divisibility(s, w, g=g)
    if reason is None and g not in (2, 4, 8):
        reason = f"the fused kernel takes groups of 2, 4 or 8, got {g}"
    return reason


@register("apec_matmul", CUDA, platforms=("cuda",), priority=20,
          supports=_apec_csr_supports, vjp=_matmul_bwd)
def _apec_matmul_csr(s, w, *, g=2, occupancy=None):
    # Fused event-compacted APEC: union work list, overlap partial sums
    # added into the g member rows in-kernel. A carried map IS the union
    # gate (an s tile is occupied iff its res or ov tile is).
    from repro_torch.kernels import ops
    return ops.apec_matmul_csr(s, w, g=g, occupancy=occupancy)


@register("apec_matmul", CUDA_PACKED, platforms=("cuda",), priority=30,
          supports=_apec_csr_supports, vjp=_matmul_bwd, payload=("packed",))
def _apec_matmul_packed(s, w, *, g=2, occupancy=None, packed_k=None):
    # The fused kernel on words end to end: decompose on the words, union
    # work list, both operands' word tiles unpacked on chip.
    from repro_torch.kernels import ops
    return ops.apec_matmul_packed(s, w, g=g, packed_k=packed_k,
                                  occupancy=occupancy)


# ------------------------------------------------------------------ sdsa
def _sdsa_example(dev):
    return tuple(_binary((2, 3, 24, 40), 0.4, dev) for _ in range(3)), \
        {"mode": "or"}


register_op("sdsa", _sdsa_example)


def _sdsa_or_only(q, k, v, *, mode="or") -> Optional[str]:
    del q, k, v
    if mode != "or":
        return f"packed bitwise path supports mode='or' only, got {mode!r}"
    return None


@register("sdsa", REF, priority=0, differentiable=True)
def _sdsa_ref(q, k, v, *, mode="or"):
    from repro_torch.core.sdsa import sdsa_jnp
    return sdsa_jnp(q, k, v, mode=mode)


@register("sdsa", CUDA, platforms=("cuda",), priority=20,
          supports=_sdsa_or_only, vjp=REF)
def _sdsa_cuda(q, k, v, *, mode="or"):
    del mode
    from repro_torch.kernels import ops
    return ops.sdsa_or(q, k, v)


# ----------------------------------------------------------------- econv
def _econv_example(dev):
    s = _binary((2, 8, 8, 6), 0.25, dev)
    w = torch.randn(3, 3, 6, 10, generator=torch.Generator().manual_seed(1))
    return (s, w.to(dev)), {"stride": 1, "padding": "SAME"}


register_op("econv", _econv_example)


@register("econv", REF, priority=0, differentiable=True)
def _econv_ref(s, w, *, stride=1, padding="SAME", occupancy=None):
    del occupancy    # dense conv: no event metadata consumed
    from repro_torch.core.econv import tconv
    return tconv(s, w, stride=stride, padding=padding)


def econv_patches(s: torch.Tensor, kh: int, kw: int, stride: int,
                  padding: str) -> torch.Tensor:
    """im2col of NHWC `s`: (N*Ho*Wo, Ci*kh*kw) patch rows with features
    ordered (Ci, kh, kw), as lax's `conv_general_dilated_patches` (and
    `F.unfold` on NCHW) order them."""
    from repro_torch.core.econv import pad_nchw
    x = pad_nchw(s.permute(0, 3, 1, 2), kh, kw, stride, padding)
    cols = torch.nn.functional.unfold(x, (kh, kw), stride=stride)
    return cols.transpose(1, 2).reshape(-1, cols.shape[1]).contiguous()


def _econv_im2col(s, w, stride, padding, matmul, occupancy=None):
    """im2col + an occupancy-skipping spike matmul: binary patches of a
    binary map stay binary, so the event matmul is the conv, and patch
    tiles with no events cost no work. `matmul` picks the kernel (the
    event-compacted `ops.spike_matmul_csr` or the predicated
    `ops.spike_matmul`). `occupancy` is a map for the PATCH matrix — the
    input map propagated through the im2col window
    (`core.events.conv_patch_occupancy`), never a re-scan of the
    kh*kw-times larger patch tensor."""
    from repro_torch.core.econv import conv_pads
    kh, kw, ci, co = w.shape
    ho = conv_pads(s.shape[1], kh, stride, padding)[0]
    wo = conv_pads(s.shape[2], kw, stride, padding)[0]
    patches = econv_patches(s, kh, kw, stride, padding)
    w2 = w.permute(2, 0, 1, 3).reshape(ci * kh * kw, co)
    out = matmul(patches, w2.float(), occupancy=occupancy)
    return out.reshape(s.shape[0], ho, wo, co)


@register("econv", CUDA, platforms=("cuda",), priority=20, vjp=REF)
def _econv_cuda(s, w, *, stride=1, padding="SAME", occupancy=None):
    from repro_torch.kernels import ops
    return _econv_im2col(s, w, stride, padding, ops.spike_matmul_csr,
                         occupancy)


@register("econv", CUDA_PACKED, platforms=("cuda",), priority=30, vjp=REF,
          payload=("packed",))
def _econv_packed(s, w, *, stride=1, padding="SAME", occupancy=None,
                  packed_k=None):
    # Word-domain im2col (strided slices of the padded words) + the packed
    # CSR kernel; `ops.econv_packed` relays the weights to the patch
    # feature order.
    from repro_torch.kernels import ops
    return ops.econv_packed(s, w, stride=stride, padding=padding,
                            packed_k=packed_k, occupancy=occupancy)


@register("econv", CUDA_PRED, auto=False, vjp=REF)
def _econv_pred(s, w, *, stride=1, padding="SAME", occupancy=None):
    from repro_torch.kernels import ops
    return _econv_im2col(s, w, stride, padding, ops.spike_matmul, occupancy)


def _econv_scatter_supports(s, w, *, stride=1, padding="SAME", **kwargs):
    del s, kwargs
    kh, kw = w.shape[:2]
    if kh % 2 == 0 or kw % 2 == 0:
        return f"event scatter needs odd kernels, got {(kh, kw)}"
    if stride != 1 or padding != "SAME":
        return f"event scatter is stride-1/SAME only, got {stride}/{padding}"
    return None


# Event extraction + index_add_ scatter: the faithful Algorithm 1 form.
# Its backward replays the dense conv (`vjp="ref"`), as in `repro`.
@register("econv", "jnp", auto=False, supports=_econv_scatter_supports,
          vjp=REF)
def _econv_scatter(s, w, *, stride=1, padding="SAME", occupancy=None):
    del stride, padding, occupancy
    from repro_torch.core.econv import econv_scatter
    return econv_scatter(s, w)


# ----------------------------------------------------------------- tconv
# The transposed conv of SegNet's decoder (16TC3, 2TC3). Zero-insertion
# dilates event addresses but keeps the events binary, so its kernel form
# is im2col + the predicated spike matmul; the patch map comes from a
# dense pre-pass (no map survives the zero-insertion).
def _tconv_example(dev):
    s = _binary((2, 6, 6, 5), 0.3, dev)
    w = torch.randn(3, 3, 5, 4, generator=torch.Generator().manual_seed(1))
    return (s, w.to(dev)), {"stride": 2, "padding": "SAME"}


register_op("tconv", _tconv_example)


def _tconv_pad_supports(s, w, *, stride=2, padding="SAME") -> Optional[str]:
    del s, w
    if padding not in ("SAME", "VALID"):
        return f"upsample form supports SAME/VALID, got {padding!r}"
    if stride < 1:
        return f"stride must be >= 1, got {stride}"
    return None


@register("tconv", REF, priority=0, differentiable=True)
def _tconv_ref(s, w, *, stride=2, padding="SAME"):
    from repro_torch.core.econv import conv_transpose_ref
    return conv_transpose_ref(s, w, stride=stride, padding=padding)


# Zero-insertion + stride-1 conv: the same linear map as the oracle, so
# autograd through it gives ref's cotangents.
@register("tconv", "jnp", auto=False, supports=_tconv_pad_supports,
          differentiable=True)
def _tconv_upsampled(s, w, *, stride=2, padding="SAME"):
    from repro_torch.core.econv import conv_transpose_upsampled
    return conv_transpose_upsampled(s, w, stride=stride, padding=padding)


@register("tconv", CUDA, platforms=("cuda",), priority=20,
          supports=_tconv_pad_supports, vjp=REF)
def _tconv_cuda(s, w, *, stride=2, padding="SAME"):
    from repro_torch.core.econv import upsample_events
    from repro_torch.kernels import ops
    up = upsample_events(s, stride, w.shape[0], w.shape[1], padding)
    return _econv_im2col(up, w, 1, "VALID", ops.spike_matmul)


# ======================================================================
# Public entry points (EventTensor-aware)
# ======================================================================
# Full-event operands: an `EventTensor` carries spikes plus their map;
# unpack it into (spikes, occupancy-kwarg) for the registered backends.
# Event backends consume the carried map, oracles ignore it, and either
# way the values are identical — occupancy only gates what is provably
# zero. A map carried for the wrong tiling raises before resolution. A
# packed-only EventTensor hands over its words and the `packed_k` marker
# that routes the call to the packed backends.
def _payload(s, kw):
    if s.is_packed:
        kw["packed_k"] = s.feature_size
        return s.packed
    return s.spikes


def _event_args(s, kw=None):
    from repro_torch.core.events import EventTensor
    kw = dict(kw or {})
    if isinstance(s, EventTensor):
        occ = s.occupancy_for(128, 128)
        if occ is not None:
            kw["occupancy"] = occ
        s = _payload(s, kw)
    return s, kw


def lif_scan(x, *, decay=0.5, v_th=1.0, soft_reset=True, surrogate_alpha=2.0):
    return dispatch("lif_scan", x, decay=decay, v_th=v_th,
                    soft_reset=soft_reset, surrogate_alpha=surrogate_alpha)


def lif_scan_occ(x, *, decay=0.5, v_th=1.0, soft_reset=True,
                 surrogate_alpha=2.0, packed=False):
    """Fire + emit the occupancy maps: returns (spikes, (128,128) tile
    map, 8-row chunk map) — wrap in an EventTensor via
    `models.layers.lif_fire_events`. With ``packed=True`` the first
    element is the uint32 words instead (forward only: the kernel writes
    words and counts, and no f32 spike tensor)."""
    return dispatch("lif_scan_occ", x, decay=decay, v_th=v_th,
                    soft_reset=soft_reset, surrogate_alpha=surrogate_alpha,
                    packed=packed)


def spike_matmul(s, w):
    s, kw = _event_args(s)
    return dispatch("spike_matmul", s, w, **kw)


def apec_matmul(s, w, *, g=2):
    s, kw = _event_args(s, {"g": g})
    return dispatch("apec_matmul", s, w, **kw)


def sdsa(q, k, v, *, mode="or"):
    from repro_torch.core.events import as_spikes
    return dispatch("sdsa", as_spikes(q), as_spikes(k), as_spikes(v),
                    mode=mode)


def econv(s, w, *, stride=1, padding="SAME"):
    from repro_torch.core.events import EventTensor, conv_patch_occupancy
    kw = {"stride": stride, "padding": padding}
    if isinstance(s, EventTensor):
        # The carried map is for the INPUT flattening — the im2col patch
        # matrix has different rows/K, so the map is propagated through
        # the window, not passed through as-is.
        occ = conv_patch_occupancy(s, w.shape, stride, padding)
        if occ is not None:
            kw["occupancy"] = occ
        s = _payload(s, kw)
    return dispatch("econv", s, w, **kw)


def tconv(s, w, *, stride=2, padding="SAME"):
    """Transposed conv. Zero-insertion dilates event addresses, so a
    carried map does not survive: the dense view only (the documented
    invalidation rule)."""
    from repro_torch.core.events import as_spikes
    return dispatch("tconv", as_spikes(s), w, stride=stride, padding=padding)
