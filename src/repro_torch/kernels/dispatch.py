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
  spike_matmul  cuda-pipe    csrc/spike_matmul_csr_pipe.cu on the carried
                             map (cp.async ring; kernel 11's sums)
                cuda-packed-pipe  its word kernel (packed payload)
                cuda         csrc/spike_matmul_csr.cu, serial fp32
                             event walk (kernel 11)
                cuda-packed  csrc/spike_matmul_csr.cu's word kernel
                             (packed payload)
                cuda-pred    csrc/spike_matmul.cu, predicated (manual)
  sdsa          cuda         csrc/sdsa.cu on the spikes as they lie, one
                             launch (mode="or")
  causal_sdsa   cuda         csrc/sdsa_causal.cu on the spikes as they
                             lie: T-fold, prefix-OR and Q AND in one
                             launch (mode="or")
                jnp          word T-fold, prefix-OR and Q AND in plain
                             PyTorch (manual)
  econv         cuda-pipe    im2col + csrc/spike_matmul_csr_pipe.cu
                cuda-packed-pipe  word-domain im2col + its word kernel
                             (packed payload)
                cuda         im2col + csrc/spike_matmul_csr.cu
                cuda-packed  word-domain im2col + the serial word kernel
                             (packed payload)
                cuda-pred    im2col + csrc/spike_matmul.cu (manual)
                jnp          per-event scatter, `econv_scatter` (manual)
  tconv         cuda         zero-insertion + im2col + csrc/spike_matmul.cu
                jnp          zero-insertion + dense conv (manual)
  apec_matmul   cuda-pipe    csrc/apec.cu + csrc/apec_matmul_csr_pipe.cu
                             (union work list, both products in one
                             pass on the cp.async ring, on the tensor
                             cores: an exact bf16 split of the weights)
                cuda-packed-pipe  csrc/apec.cu + its word kernel (packed
                             payload)
                cuda         csrc/apec.cu + csrc/apec_matmul_csr.cu, serial
                cuda-packed  csrc/apec.cu + csrc/apec_matmul_csr.cu's word
                             kernel (packed payload)
                cuda-pred    csrc/apec.cu + two csrc/spike_matmul.cu launches
                             (manual)
                jnp          overlap-reuse dense form, `core.apec` (auto on
                             every platform, above `ref`, as in `repro`)

(`tconv` is the transposed conv of SegNet's decoder; the dense forward
conv oracle of `econv` is `core.econv.tconv`, the paper's "TConv".)

Selection order per call (`repro`'s resolution walk on CPU tensors):
  1. an explicit override — the `use_backend(...)` context or the
     ``EXSPIKE_BACKEND`` env var (``ref`` for all ops, or a comma list of
     ``op=backend`` entries). It runs the named backend on whatever
     device the tensors lie on: the kernel wrappers take their plain
     version for CPU tensors, which is how the CPU tests walk the kernel
     path. When its `supports` gate refuses the call, resolution walks
     the backend's declared ``fallback=`` chain (``cuda-packed-pipe`` ->
     ``cuda-packed`` -> ``cuda`` -> ``cuda-pred`` and ``cuda-pipe`` ->
     ``cuda`` for the matmul-form ops and APEC, as `repro`'s
     ``packed-csr-pipe`` -> ``packed-csr`` -> ``pallas-csr`` ->
     ``pallas``) and ends at `ref`;
     an unknown name lands on `ref` too;
  2. otherwise the automatic (``auto=True``) backends registered for the
     platform of the call's first tensor (``cpu`` or ``cuda``) and for the
     call's payload, in priority order: the first whose gate accepts the
     call runs, and when every one refuses, `ref` does.
Every degrade warns once per (op, from, to) edge (`reset_fallback_warnings`
re-arms them) and is attributed ``<chosen><-<requested>``
(`resolve_with_attribution`, `watch_resolutions`); a platform or payload
that a backend does not take is filtered silently. The mesh routing of
`repro`'s registry is not ported yet.

Hybrid resolution (`use_hybrid`, ``EXSPIKE_BACKEND=hybrid``, `repro`'s
density-adaptive routing): a call of `HYBRID_OPS` that carries an
occupancy map picks between an event route and a dense route from the map's
occupied-tile count, bucketed in pow2 bands, on the cost model's
calibrated crossover (`core.costmodel.event_route_wins`, fit on the H100
sweep `tools/route_sweep_h100.json`). The pair (`_hybrid_route_pair`) is
the serial event walk `cuda` and its declared non-event fallback
`cuda-pred`, `repro`'s ``pallas-csr`` and ``pallas``:

  op            event route (cuda)            dense route (cuda-pred)
  ------------  ----------------------------  ---------------------------
  spike_matmul  kernel 11 (TPU row 11)        kernel 10 (TPU row 10)
  apec_matmul   decompose + kernel 17 (row    decompose + two kernel-10
                17)                           launches + the repeat
  econv         im2col + kernel 11            im2col + kernel 10

A map on the CPU is read there and the route is chosen in Python,
attributed ``<route><-hybrid[b<bucket>]``; hybrid is an explicit request,
so on CPU tensors the chosen route runs its plain versions. A map on the
card is never read on the host: the call resolves to
``hybrid[cuda|cuda-pred@b<threshold>]``, whose body launches both routes'
kernels behind one flag computed on the card (`ops.hybrid_route`), the
one not chosen returning at block entry; what both routes share (the
im2col, APEC's decompose) is built once. It is `repro`'s `lax.cond` on the
bucketed count, and one CUDA graph of a call takes its route from the map
present at replay. Hybrid disengages (automatic selection, attributed
``<backend><-hybrid``) without a map, on packed payloads, or without a
route pair; a blanket `use_hybrid()` leaves the other ops untouched.
Where one route's gate refuses the call, the other is pinned (warned
once); where both refuse, the normal walk runs, and on the card it raises
before it lands on a plain route.

On the card (CUDA tensors) a degrade may only move from one kernel route
to another (`KERNEL_ROUTES`, along the declared chain, under automatic
selection too). Where the walk would end at a plain route (`ref`, `jnp`,
or `ref` behind the unpack shim), or the override names no registered
backend, resolution raises with the reason: a plain version never stands
in for a kernel on the card. An explicit override that names a plain
route still runs it. A kernel that fails to build or launch raises
everywhere.

Payload routing (as in `repro`): a call whose spike operand is uint32
words carries the ``packed_k=`` kwarg (the logical channel count, threaded
from a packed `EventTensor`). Automatic selection takes it only to a
backend declaring ``payload=("packed",)`` (or, on the CPU, to `ref`) and
never takes a dense call there. Wherever a packed call reaches a dense
backend (`ref` on the CPU, a degrade, or an explicit override), the words
are unpacked by an explicit shim that warns once and is attributed
``<backend>+unpack``.

Guarded execution (`use_guard`, ``EXSPIKE_GUARD``, as in `repro`): a call of
`GUARDED_OPS` that carries a map is wrapped outermost, after the unpack
shim and the hybrid resolution, in the active trust policy: ``off`` (the
default) adds nothing; ``audit`` checks that the map is an upper bound of
the payload's support; ``repair`` recomputes a violated call on the
payload alone. Where the map lives picks the semantics: a map on the host
is read there (audit raises `GuardViolationError`, repair runs the payload
alone, `repro`'s concrete semantics); a map on the card is never read on
the host (`repro`'s traced semantics): audit NaN-poisons the outputs with
one device flag, and repair launches kernel 10 on the payload behind that
flag (`ops.guard_repair`). Where the payload lives picks the trusted
route: `ref` on the host, a kernel route on the card (`cuda-pred` for a
wrong grid or a host map), never `ref`. See `_guard_shim`.

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
import math
import os
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.spikes import unpack_spikes_padded

ENV_VAR = "EXSPIKE_BACKEND"
REF = "ref"
# Override value selecting density-adaptive hybrid resolution instead of a
# backend (see `use_hybrid`), and the ops it routes: matmul-form consumers
# of a carried (MT, KT) occupancy map with an event/dense route pair.
HYBRID = "hybrid"
HYBRID_OPS = ("spike_matmul", "apec_matmul", "econv")
CUDA = "cuda"
CUDA_PRED = "cuda-pred"
CUDA_PACKED = "cuda-packed"
CUDA_PIPE = "cuda-pipe"
CUDA_PACKED_PIPE = "cuda-packed-pipe"
ALL_PLATFORMS = ("cpu", "cuda")
PACKED_OPS = ("spike_matmul", "econv", "apec_matmul")   # take packed_k=
# The routes whose wrappers launch a hand-written kernel on CUDA tensors:
# the event routes, which walk a work list of occupied tiles, and the
# predicated `cuda-pred`.
EVENT_ROUTES = (CUDA_PACKED_PIPE, CUDA_PIPE, CUDA_PACKED, CUDA)
KERNEL_ROUTES = EVENT_ROUTES + (CUDA_PRED,)


@dataclasses.dataclass(frozen=True)
class Backend:
    """One registered implementation of an op. `supports(*args, **kw)`
    returns a reason string when it cannot take the call (None: it can);
    `platforms` are the devices it is auto-selected on; an ``auto=False``
    backend is never auto-selected, only named by an override; `payload`
    names the spike payloads it is auto-selected for ("dense" f32 spikes,
    "packed" uint32 words); `fallback` names the backend a refused call
    degrades to (see `register`)."""
    name: str
    fn: Callable
    platforms: Tuple[str, ...] = ALL_PLATFORMS
    priority: int = 0
    auto: bool = True
    supports: Optional[Callable[..., Optional[str]]] = None
    differentiable: bool = False
    payload: Tuple[str, ...] = ("dense",)
    fallback: Optional[str] = None

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
             fallback=None, payload=("dense",)):
    """Decorator: register `fn` as backend `name` for `op`. ``auto=False``
    keeps it out of priority resolution: only `use_backend` or
    ``EXSPIKE_BACKEND`` reach it. ``payload=("packed",)`` makes it the
    automatic choice for packed-word calls (and never for dense ones).

    ``fallback``: the backend a call degrades to when this backend's
    `supports` gate refuses it (chained until some backend accepts; `ref`
    stays the terminal fallback). Automatic selection already falls
    through by priority and walks a chain only for packed calls.

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
            fallback=fallback, payload=tuple(payload))
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


def example_inputs(op: str, device="cuda") -> Tuple[tuple, dict]:
    """Small (args, kwargs) for `op` on `device`, the parity harness's
    inputs (deterministic: drawn from fixed seeds)."""
    from repro_torch import resolve_device
    return _REGISTRY[op].make_example(resolve_device(device))


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


@contextlib.contextmanager
def use_hybrid(op: Optional[str] = None):
    """Density-adaptive hybrid resolution (``EXSPIKE_BACKEND=hybrid`` is
    the env-var spelling): while active, calls of `HYBRID_OPS` (all of
    them, or `op`) that carry an occupancy map pick between the event and
    the dense route PER CALL, on the cost model's calibrated crossover at
    the map's occupied-tile count, bucketed into pow2 bands. A CPU map
    resolves in Python (attribution ``<route><-hybrid[b<bucket>]``); a
    CUDA map on the card, with no host read (attribution
    ``hybrid[<event>|<dense>@b<threshold>]``). Calls hybrid cannot route
    (no carried map, a packed payload, no route pair) fall through to
    automatic selection, tagged ``<-hybrid``. See the module doc."""
    with use_backend(HYBRID, op=op):
        yield


# -------------------------------------------------------------- resolution
def _platform(args) -> str:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device.type
    raise TypeError("dispatch needs at least one tensor argument")


# Degrade warnings fire once per (op, from-backend, to-backend, route) per
# process, so a model that makes the same refused call in every layer
# shows the one warning that matters; `reset_fallback_warnings()` re-arms
# every edge.
_WARNED: set = set()


def reset_fallback_warnings() -> None:
    _WARNED.clear()


def _warn_once(op: str, src: str, dst: str, msg: str, stacklevel: int = 3,
               route: Optional[str] = None) -> None:
    key = (op, src, dst, route)
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(msg, RuntimeWarning, stacklevel=stacklevel + 1)


# Observers appended by `watch_resolutions`: every resolution records
# {"op", "backend", "attribution"}.
_RESOLUTION_WATCHERS: list = []


@contextlib.contextmanager
def watch_resolutions():
    """Yields a list that receives one ``{"op", "backend", "attribution"}``
    record per resolution while the context is active (one per call: the
    port resolves eagerly)."""
    rec: list = []
    _RESOLUTION_WATCHERS.append(rec)
    try:
        yield rec
    finally:
        _RESOLUTION_WATCHERS.remove(rec)


# ------------------------------------------------------------ guard policy
# The event stack trusts metadata it never re-derives: carried occupancy
# maps gate which tiles the event kernels visit, and packed uint32 words
# ARE the payload. An undercounting or stale map drops live spike
# contributions with no exception. EXSPIKE_GUARD (or the `use_guard`
# context) threads a trust policy through every call of GUARDED_OPS that
# carries a map:
#
#   off    — (default) trust the metadata: no added work, the same backend
#            and attribution;
#   audit  — check that the carried map is a TRUE UPPER BOUND of the
#            payload's support: an exact any-nonzero per 128 x 128 tile of
#            dense spikes, a per-word popcount of packed ones, against the
#            map. A host map that fails raises GuardViolationError; a card
#            map NaN-poisons the float outputs (no host read);
#   repair — a violated call stops trusting the metadata and runs on the
#            payload alone (words unpacked, map dropped), warned once and
#            attributed `<be>+repaired`: kernel 10 behind the violation
#            flag for a card map; for a host map, `ref` on a host payload
#            and `cuda-pred` on a card payload (never a plain version on
#            the card).
#
# Upper bound, not equality: propagated maps (conv windows, pooling)
# legitimately overcount, so only support where the map claims empty is a
# violation; overcounts never flag. econv's map tiles the im2col patch
# matrix, so its audit is the static grid check only.
GUARD_ENV_VAR = "EXSPIKE_GUARD"
GUARD_MODES = ("off", "audit", "repair")
GUARDED_OPS = HYBRID_OPS
_SUPPORT_AUDITED_OPS = ("spike_matmul", "apec_matmul")
_GUARD: list = []            # stack pushed by use_guard()


class GuardViolationError(ValueError):
    """A carried occupancy map failed the upper-bound invariant (payload
    support in a tile the map claims empty) or arrived on the wrong tile
    grid for its payload (stale / wrong tiling)."""


def guard_mode() -> str:
    """Active guard policy: innermost `use_guard` frame, else the
    EXSPIKE_GUARD env var, else "off". Read at resolution, which in the
    eager port is every call; a captured CUDA graph keeps the mode it was
    captured under."""
    if _GUARD:
        return _GUARD[-1]
    env = os.environ.get(GUARD_ENV_VAR, "").strip().lower()
    if not env:
        return "off"
    if env not in GUARD_MODES:
        raise ValueError(
            f"{GUARD_ENV_VAR}={env!r}: expected one of {GUARD_MODES}")
    return env


@contextlib.contextmanager
def use_guard(mode: str):
    """Scoped guard policy (see the "guard policy" block above)."""
    if mode not in GUARD_MODES:
        raise ValueError(
            f"guard mode {mode!r}: expected one of {GUARD_MODES}")
    _GUARD.append(mode)
    try:
        yield
    finally:
        _GUARD.pop()


# Observers appended by `watch_guard_events`: one record per detected
# violation — {"op", "backend", "kind", "mode", "action", "attribution",
# "detail"}, plus "traced": True where the violation was detected on the
# card (the port's counterpart of `repro`'s detection under jit). A card
# map's flag is read on the host only while a watcher is open.
_GUARD_WATCHERS: list = []


@contextlib.contextmanager
def watch_guard_events():
    rec: list = []
    _GUARD_WATCHERS.append(rec)
    try:
        yield rec
    finally:
        _GUARD_WATCHERS.remove(rec)


def _guard_record(event: dict) -> None:
    for rec in _GUARD_WATCHERS:
        rec.append(dict(event))


def _guard_grid(op: str, args: tuple, packed_k,
                kwargs: dict) -> Optional[Tuple[int, int]]:
    """Expected (MT, KT) 128x128 tile grid of the carried map for this
    payload — the flattening `ops.padded_occupancy` and the fires' maps use
    (rows = prod(leading dims), K = logical features). For econv the map
    tiles the im2col patch matrix, so the grid comes from the conv
    geometry. None: geometry unknown, skip the static check."""
    s = args[0]
    if op == "econv":
        if len(args) < 2 or getattr(s, "ndim", 0) < 4:
            return None
        kh, kw_, ci, _ = (int(d) for d in args[1].shape)
        h, w_ = int(s.shape[-3]), int(s.shape[-2])
        stride = int(kwargs.get("stride", 1))
        padding = kwargs.get("padding", "SAME")
        if padding == "SAME":
            ho, wo = -(-h // stride), -(-w_ // stride)
        elif padding == "VALID":
            ho, wo = (h - kh) // stride + 1, (w_ - kw_) // stride + 1
        else:
            return None
        rows = math.prod(s.shape[:-3]) * ho * wo
        k = ci * kh * kw_
    else:
        rows = math.prod(s.shape[:-1])
        k = int(packed_k) if packed_k is not None else int(s.shape[-1])
    return (-(-rows // 128), -(-k // 128))


def _support_violation(s, occupancy, packed_k):
    """(support, violated): the payload's (MT, KT) int32 per-tile support
    counts (nonzeros of dense spikes, popcounts of packed words, 4 words a
    k-tile; counted in place, `ops.support_map`) and a 0-d bool tensor on
    the payload's device, set where the payload has support in a tile the
    carried map claims empty. Exact, not sampled: detection must be total
    for the guard's contract."""
    from repro_torch.kernels import ops
    support = ops.support_map(s, packed_k)
    return support, ((support > 0) & (occupancy == 0)).any()


def _repair_route(op: str, args: tuple, kwargs: dict, route: str = REF):
    """The guard's safe route: trust only the payload — unpack words, drop
    the map, run `route`: the `ref` oracle for a payload on the host; for
    one on the card the op's predicated kernel route `cuda-pred` (kernel
    10 with its own pre-pass of the payload), never a plain version. Both
    keep the op's gradient contract."""
    kw = {k: v for k, v in kwargs.items()
          if k not in ("occupancy", "packed_k", "csr")}
    s = args[0]
    pk = kwargs.get("packed_k")
    if pk is not None:
        s = unpack_spikes_padded(s, pk)
    return _REGISTRY[op].backends[route].fn(s, *args[1:], **kw)


def _guard_repair_body(inner):
    """The repair of a call on a card map: the resolved backend on the
    carried map, then kernel 10 on the payload alone (words unpacked) with
    its exact support map, launched behind the violation flag
    (`ops.guard_repair`): where the flag is set its product overwrites the
    output. The gradient is the matmul rule's, the trusted route's and the
    unguarded backends' alike."""
    def body(s, w, *, occupancy, support, flag, packed_k=None, **static):
        kw = dict(static, occupancy=occupancy)
        if packed_k is not None:
            kw["packed_k"] = packed_k
        out = inner(s, w, **kw)
        from repro_torch.kernels import ops
        payload = s if packed_k is None else unpack_spikes_padded(s, packed_k)
        return ops.guard_repair(payload, w, support, flag, out)
    return body


def _guard_shim(be: Backend, op: str, mode: str) -> Backend:
    """Wrap a resolved backend in the active guard policy. The backend
    name/attribution are unchanged (the guard is policy, not routing);
    detections surface through GuardViolationError / `watch_guard_events`
    records / the warn-once `<be>+repaired` repair attribution."""
    inner = be.fn
    repaired = f"{be.name}+repaired"

    @functools.wraps(inner)
    def fn(*args, **kwargs):
        occ = kwargs.get("occupancy")
        pk = kwargs.get("packed_k")
        if occ is None or getattr(occ, "ndim", 0) != 2:
            return inner(*args, **kwargs)
        # Where the map lives picks a host read or a device flag; where
        # the payload lives picks the trusted route (a kernel on the card).
        on_card = _device_routed(occ)
        trusted = CUDA_PRED if _platform(args) == "cuda" else REF
        expected = _guard_grid(op, args, pk, kwargs)
        if expected is not None and tuple(occ.shape) != expected:
            # Shapes are static: this check reads nothing on the card and
            # raises in both semantics (inside a CUDA graph capture too).
            detail = (f"carried map grid {tuple(occ.shape)} != expected "
                      f"{expected} for the payload (stale/wrong tiling)")
            if mode == "audit":
                _guard_record({"op": op, "backend": be.name, "kind": "grid",
                               "mode": mode, "action": "raise",
                               "attribution": be.name, "detail": detail})
                raise GuardViolationError(f"guard[{op}/{be.name}]: {detail}")
            _guard_record({"op": op, "backend": be.name, "kind": "grid",
                           "mode": mode, "action": "repair",
                           "attribution": repaired, "detail": detail})
            _warn_once(op, be.name, repaired,
                       f"exspike guard: {detail}; repairing op {op!r} on "
                       f"the trusted-payload route ({repaired!r})",
                       route="guard")
            return _repair_route(op, args, kwargs, trusted)
        if op not in _SUPPORT_AUDITED_OPS:
            return inner(*args, **kwargs)
        support, violated = _support_violation(args[0], occ, pk)
        detail = ("carried map claims empty tiles that hold payload "
                  "support (occupancy undercount / corrupted payload)")
        event = {"op": op, "backend": be.name, "kind": "undercount",
                 "mode": mode, "detail": detail}
        if not on_card:
            if not bool(violated):
                return inner(*args, **kwargs)
            if mode == "audit":
                _guard_record({**event, "action": "raise",
                               "attribution": be.name})
                raise GuardViolationError(f"guard[{op}/{be.name}]: {detail}")
            _guard_record({**event, "action": "repair",
                           "attribution": repaired})
            _warn_once(op, be.name, repaired,
                       f"exspike guard: {detail}; repairing op {op!r} on "
                       f"the trusted-payload route ({repaired!r})",
                       route="guard")
            return _repair_route(op, args, kwargs, trusted)
        # A map on the card: no data-dependent raise and no host read (a
        # sync in every guarded call would stall the launch queue):
        #   audit  — NaN-poison the float outputs when violated, a loud
        #            sentinel for the downstream NaN guards (the serve
        #            loop quarantines non-finite logits) instead of a
        #            plausible wrong number; clean, `* 1` is exact;
        #   repair — kernel 10 on the payload behind the flag; the answer
        #            is right either way, and a CUDA graph of the call
        #            takes the flag from the map present at replay.
        # The flag is read on the host only while a watcher is open.
        action = "record" if mode == "audit" else "repair"
        attribution = be.name if mode == "audit" else repaired
        if _GUARD_WATCHERS and bool(violated):
            _guard_record({**event, "action": action, "traced": True,
                           "attribution": attribution})
            _warn_once(op, be.name, attribution,
                       f"exspike guard: {detail} (op {op!r}, detected "
                       f"on the card"
                       + ("; repaired on the trusted-payload route"
                          if mode == "repair" else "") + ")",
                       route="guard")
        if mode == "audit":
            out = inner(*args, **kwargs)
            return out * torch.where(violated, torch.nan, 1.0).to(out.dtype)
        return _wrap_vjp(op, _guard_repair_body(inner), _matmul_bwd)(
            *args, support=support, flag=violated.to(torch.int32).reshape(1),
            **kwargs)
    return dataclasses.replace(be, fn=fn)


def _fallback(op: str, wanted: str, reason: str, on_card: bool) -> Backend:
    """`ref` in place of `wanted`, warned once; on the card, an error: the
    plain version never stands in for a kernel there."""
    if on_card:
        raise ValueError(f"exspike dispatch: backend {wanted!r} for op "
                         f"{op!r} cannot take this call on the card "
                         f"({reason}), and no kernel route is left to "
                         f"degrade to")
    _warn_once(op, wanted, REF,
               f"exspike dispatch: backend {wanted!r} for op {op!r} "
               f"unavailable ({reason}); falling back to {REF!r}",
               stacklevel=6)
    return _REGISTRY[op].backends[REF]


def _walk_fallback_chain(op: str, spec: OpSpec, be: Backend,
                         reason: Optional[str],
                         reason_of) -> Tuple[Backend, Optional[str]]:
    """Degrade along the declared fallback chain while `reason_of`
    refuses, warning once per edge. Returns the last backend reached and
    its reason (None iff some link accepted the call)."""
    seen = {be.name}
    while reason is not None and be.fallback is not None \
            and be.fallback not in seen:
        nxt = spec.backends.get(be.fallback)
        if nxt is None:
            break
        _warn_once(op, be.name, nxt.name,
                   f"exspike dispatch: backend {be.name!r} for op {op!r} "
                   f"unavailable ({reason}); degrading to {nxt.name!r}",
                   stacklevel=6)
        seen.add(nxt.name)
        be, reason = nxt, reason_of(nxt)
    return be, reason


# ---------------------------------------------------- hybrid resolution
def _hybrid_route_pair(spec: OpSpec) -> Optional[Tuple[Backend, Backend]]:
    """(event route, dense route): the highest-priority dense-payload event
    route whose declared fallback is not an event route, and that fallback
    (`repro`'s rule: a ``csr`` backend declaring a dense fallback). The
    pipelined routes declare the serial walk as fallback, so the pair is
    `cuda` and `cuda-pred`. None when either half is missing (hybrid then
    disengages). Hybrid is an explicit request, so the pair is not
    filtered by platform: on CPU tensors it runs the plain versions."""
    event = max(
        (b for b in spec.backends.values()
         if b.name in EVENT_ROUTES and "dense" in b.payload
         and b.fallback in spec.backends and b.fallback not in EVENT_ROUTES),
        key=lambda b: b.priority, default=None)
    if event is None:
        return None
    return event, spec.backends[event.fallback]


def _hybrid_device_fn(op: str, event_be: Backend, dense_be: Backend,
                      mt: int, kt: int, threshold: int):
    """The body of a hybrid call on a CUDA map: both routes' kernels
    behind the flags `ops.hybrid_route` computes on the card (`repro`'s
    `lax.cond` on the bucketed count), or one route alone where the
    threshold routes every bucket of an (mt, kt) map the same way."""
    from repro_torch.core import costmodel
    if threshold < 0:
        return dense_be.fn
    if threshold >= costmodel.num_buckets(mt * kt) - 1:
        return event_be.fn
    body, rule = _HYBRID_BODIES[op]
    return _wrap_vjp(op, functools.partial(body, threshold=threshold), rule)


def _hybrid_resolution(spec: OpSpec, op: str, kwargs,
                       reason_of) -> Optional[Tuple[Backend, str]]:
    """Resolve under the HYBRID override. Returns (backend, attribution)
    or None to disengage (no carried map / packed payload / no route
    pair); the caller then falls through to automatic selection."""
    occ = kwargs.get("occupancy")
    if op not in HYBRID_OPS or occ is None or getattr(occ, "ndim", 0) != 2:
        return None
    if kwargs.get("packed_k") is not None:
        # Packed payloads route by the `payload` capability, not by
        # density: the word kernels' bytes advantage holds at every
        # occupancy, so hybrid disengages (as in `repro`).
        return None
    pair = _hybrid_route_pair(spec)
    if pair is None:
        return None
    event_be, dense_be = pair
    event_reason = reason_of(event_be)
    dense_reason = reason_of(dense_be)
    if event_reason is not None and dense_reason is not None:
        return None          # both routes refuse: the normal walk runs
    if event_reason is not None:
        _warn_once(op, event_be.name, dense_be.name,
                   f"exspike dispatch: hybrid event route {event_be.name!r} "
                   f"for op {op!r} unavailable ({event_reason}); pinning "
                   f"dense route {dense_be.name!r}", stacklevel=6,
                   route="event")
        return dense_be, f"{dense_be.name}<-{HYBRID}"
    if dense_reason is not None:
        _warn_once(op, dense_be.name, event_be.name,
                   f"exspike dispatch: hybrid dense route {dense_be.name!r} "
                   f"for op {op!r} unavailable ({dense_reason}); pinning "
                   f"event route {event_be.name!r}", stacklevel=6,
                   route="dense")
        return event_be, f"{event_be.name}<-{HYBRID}"
    from repro_torch.core import costmodel
    mt, kt = occ.shape
    if not _device_routed(occ):
        # A map on the host: pick in Python on the band's representative
        # count, as `repro` picks for a concrete map.
        bucket = costmodel.pow2_bucket(int((occ > 0).sum()))
        rep = costmodel.bucket_representative(bucket, mt * kt)
        be = event_be if costmodel.event_route_wins(op, rep, mt, kt) \
            else dense_be
        return be, f"{be.name}<-{HYBRID}[b{bucket}]"
    threshold = costmodel.hybrid_event_bucket_threshold(op, mt, kt)
    routed = Backend(
        name=f"{HYBRID}[{event_be.name}|{dense_be.name}@b{threshold}]",
        fn=_hybrid_device_fn(op, event_be, dense_be, mt, kt, threshold),
        platforms=event_be.platforms, auto=False,
        differentiable=event_be.differentiable and dense_be.differentiable)
    return routed, routed.name


def _device_routed(occ: torch.Tensor) -> bool:
    """Whether a hybrid call chooses its route on the map's device (a CUDA
    map, which the host must not read) rather than in Python."""
    return occ.is_cuda


def _resolve_payload_blind(op: str, *args,
                           **kwargs) -> Tuple[Backend, str]:
    spec = _REGISTRY[op]
    platform = _platform(args)
    on_card = platform == "cuda"

    def reason_of(be: Backend) -> Optional[str]:
        return be.unsupported_reason(*args, **kwargs)

    def attributed(be: Backend, requested: Optional[str]):
        if requested is None or requested == be.name:
            if hybrid_requested:
                # hybrid disengaged: automatic selection ran, and the tag
                # keeps visible that hybrid was asked for and stepped aside.
                return be, f"{be.name}<-{HYBRID}"
            return be, be.name
        return be, f"{be.name}<-{requested}"

    def walk(be: Backend, reason: Optional[str]):
        # The declared chain, so a refused call lands on the nearest
        # comparable kernel; on the card only a kernel route may end it.
        be, reason = _walk_fallback_chain(op, spec, be, reason, reason_of)
        if reason is None and on_card and be.name not in KERNEL_ROUTES:
            reason = f"the chain ends at the plain route {be.name!r}"
        return be, reason

    override = _override_for(op)
    # Hybrid means something only for the ops with an event/dense pair; on
    # every other op a blanket use_hybrid() is a plain no-op (automatic
    # selection, untagged), not a disengage.
    hybrid_requested = override == HYBRID and op in HYBRID_OPS
    if override == HYBRID:
        override = None
    if hybrid_requested:
        routed = _hybrid_resolution(spec, op, kwargs, reason_of)
        if routed is not None:
            return routed
    if override is not None:
        be = spec.backends.get(override)
        if be is None:
            return attributed(_fallback(op, override, "not registered",
                                        on_card), override)
        reason = reason_of(be)
        if reason is None:     # runs as named, a plain route on the card too
            return attributed(be, override)
        be, reason = walk(be, reason)
        if reason is not None:
            return attributed(_fallback(op, be.name, reason, on_card),
                              override)
        return attributed(be, override)
    # Platform and payload filtering are silent: a dense call never
    # auto-selects a packed-only backend and vice versa (on the CPU a
    # packed call that finds no packed candidate lands on `ref` behind the
    # unpack shim; on the card it raises).
    want = "packed" if kwargs.get("packed_k") is not None else "dense"
    candidates = sorted(
        (b for b in spec.backends.values()
         if b.auto and platform in b.platforms
         and (want in b.payload or b.name == REF)),
        key=lambda b: -b.priority)
    cap_failure = None
    for be in candidates:
        if be.name == REF:
            break
        reason = reason_of(be)
        if reason is None and (cap_failure is None or not on_card):
            return attributed(be, cap_failure[0] if cap_failure else None)
        if cap_failure is None:
            cap_failure = (be.name, reason)
    if cap_failure is not None:
        if want == "packed" or on_card:
            # The refused backend's declared chain keeps the call on the
            # nearest kernel (for a packed call the shim makes the densify
            # explicit).
            be, reason = walk(spec.backends[cap_failure[0]], cap_failure[1])
            if reason is None:
                return attributed(be, cap_failure[0])
        # A capability failure degrading to the oracle would hide lost
        # kernel coverage: warn (platform filtering stays silent).
        return attributed(_fallback(op, *cap_failure, on_card),
                          cap_failure[0])
    if on_card and want == "packed":
        raise RuntimeError(f"exspike dispatch: op {op!r} has no "
                           f"packed-payload backend for this call on the "
                           f"card")
    return attributed(spec.backends[REF], None)


def _unpack_shim(be: Backend) -> Backend:
    """`be` behind an explicit unpack of packed words: the words become the
    dense f32 spikes of their `packed_k` channels and the marker is
    consumed. Attributed ``+unpack``."""
    @functools.wraps(be.fn)
    def fn(s, *rest, packed_k, **kw):
        return be.fn(unpack_spikes_padded(s, packed_k), *rest, **kw)
    return dataclasses.replace(be, fn=fn, name=f"{be.name}+unpack")


def resolve_with_attribution(op: str, *args,
                             **kwargs) -> Tuple[Backend, str]:
    """The backend `dispatch` would run for these inputs, and its
    attribution: the backend's name, suffixed ``<-requested`` when
    resolution degraded from a preferred backend (an override's chain, or
    a refused automatic candidate), and ``+unpack`` after the name when a
    packed payload reaches a dense backend. `resolve` /
    `resolve_attribution` are its two projections. On the card it raises
    where the walk would leave the kernel routes (see the module doc).
    Under `use_guard("audit" | "repair")` a call of `GUARDED_OPS` with a
    map gets the guard outermost, with the name and attribution
    unchanged."""
    be, attribution = _resolve_payload_blind(op, *args, **kwargs)
    if kwargs.get("packed_k") is not None and "packed" not in be.payload:
        _warn_once(op, "packed", be.name,
                   f"exspike dispatch: packed payload for op {op!r} "
                   f"reaches the dense backend {be.name!r}; unpacking the "
                   f"words (explicit unpack shim)", stacklevel=4,
                   route="payload")
        shim = _unpack_shim(be)
        attribution = shim.name + attribution[len(be.name):]
        be = shim
    # The guard wraps OUTERMOST, so the audit sees the payload exactly as
    # carried (packed words before any unpack shim) and also wraps the
    # hybrid device body. Off (the default) adds nothing.
    mode = guard_mode()
    if mode != "off" and op in GUARDED_OPS \
            and kwargs.get("occupancy") is not None:
        be = _guard_shim(be, op, mode)
    for rec in _RESOLUTION_WATCHERS:
        rec.append({"op": op, "backend": be.name,
                    "attribution": attribution})
    return be, attribution


def resolve(op: str, *args, **kwargs) -> Backend:
    """The backend `dispatch` would run for these inputs."""
    return resolve_with_attribution(op, *args, **kwargs)[0]


def resolve_name(op: str, *args, **kwargs) -> str:
    return resolve(op, *args, **kwargs).name


def resolve_attribution(op: str, *args, **kwargs) -> str:
    """``name``, or ``name<-requested`` after a degrade."""
    return resolve_with_attribution(op, *args, **kwargs)[1]


def dispatch(op: str, *args, **kwargs):
    """Run `op` on the resolved backend."""
    return resolve(op, *args, **kwargs).fn(*args, **kwargs)


def call_backend(op: str, name: str, *args, **kwargs):
    """Run backend `name` of `op` as registered, erroring (not falling back)
    when its `supports` gate refuses the call: an unsupported pair is an
    explicit error, never a silent comparison of `ref` with itself."""
    be = get_backend(op, name)
    reason = be.unsupported_reason(*args, **kwargs)
    if reason is not None:
        raise ValueError(f"{op}/{name} unsupported: {reason}")
    return be.fn(*args, **kwargs)


def _packed_example(op: str, dev):
    """`op`'s example inputs with the spike operand as packed words."""
    from repro_torch.core.spikes import pack_spikes_padded
    args, kwargs = _REGISTRY[op].make_example(dev)
    s = args[0]
    return ((pack_spikes_padded(s),) + tuple(args[1:]),
            {**kwargs, "packed_k": s.shape[-1]})


def resolved_backends(device="cuda", *, packed: bool = False
                      ) -> Dict[str, str]:
    """op -> attribution of the backend that would run each op's example
    inputs on `device` under the current overrides (startup log): the
    name, or ``name<-requested`` after a degrade. ``packed``: the ops
    that take a packed payload (`PACKED_OPS`) are resolved on packed
    words, as a `SpikingConfig(packed=True)` forward calls them. A
    read-only snapshot: its degrade warnings are muted and the warn-once
    ledger is restored, so a later real degrade still warns."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    out = {}
    saved = set(_WARNED)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for op, spec in _REGISTRY.items():
                if packed and op in PACKED_OPS:
                    ex_args, ex_kwargs = _packed_example(op, dev)
                else:
                    ex_args, ex_kwargs = spec.make_example(dev)
                out[op] = resolve_attribution(op, *ex_args, **ex_kwargs)
    finally:
        _WARNED.clear()
        _WARNED.update(saved)
    return out


def table() -> str:
    """Human-readable registry dump: per op, each backend with its
    priority, manual flag, gradient contract, packed payload and declared
    fallback."""
    lines = []
    for op, spec in _REGISTRY.items():
        bes = ", ".join(
            f"{b.name}(p{b.priority}{'' if b.auto else ',manual'}"
            f"{',grad' if b.differentiable else ''}"
            f"{',packed' if 'packed' in b.payload else ''}"
            f"{f',->{b.fallback}' if b.fallback else ''})"
            for b in sorted(spec.backends.values(), key=lambda b: -b.priority))
        lines.append(f"{op:14s} -> {bes}")
        pair = _hybrid_route_pair(spec) if op in HYBRID_OPS else None
        if pair is not None:
            from repro_torch.core import costmodel
            r, h = costmodel.calibrated_route_params(op)
            lines.append(
                f"{'':14s}    hybrid: event={pair[0].name} | "
                f"dense={pair[1].name} (calibrated r={r:.2f}, h={h:.2f})")
    return "\n".join(lines)


def _binary(shape, p: float, device, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
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


@register("lif_scan_occ", CUDA, platforms=("cuda",), priority=20,
          differentiable=True)
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
          vjp=_matmul_bwd, fallback=CUDA_PRED)
def _spike_matmul_csr(s, w, occupancy=None):
    # Event-compacted tile walk; a carried `occupancy` replaces the dense
    # pre-pass (the work list compacts from the small map).
    from repro_torch.kernels import ops
    return ops.spike_matmul_csr(s, w, occupancy=occupancy)


@register("spike_matmul", CUDA_PACKED, platforms=("cuda",), priority=30,
          vjp=_matmul_bwd, fallback=CUDA, payload=("packed",))
def _spike_matmul_packed(s, w, occupancy=None, packed_k=None):
    # The CSR walk on packed words: each occupied word tile unpacks on
    # chip. Dense spikes (packed_k=None) are packed at entry.
    from repro_torch.kernels import ops
    return ops.spike_matmul_packed(s, w, packed_k=packed_k,
                                   occupancy=occupancy)


# The pipelined kernels rank above the serial ones, as `repro`'s
# pallas-csr-pipe (26) and packed-csr-pipe (31) above pallas-csr (25) and
# packed-csr (30): automatic selection on the card resolves to them, and a
# refused call degrades to the serial kernel of its payload.
@register("spike_matmul", CUDA_PIPE, platforms=("cuda",), priority=26,
          vjp=_matmul_bwd, fallback=CUDA)
def _spike_matmul_csr_pipe(s, w, occupancy=None):
    from repro_torch.kernels import ops
    return ops.spike_matmul_csr(s, w, occupancy=occupancy, pipeline=True)


@register("spike_matmul", CUDA_PACKED_PIPE, platforms=("cuda",),
          priority=31, vjp=_matmul_bwd, fallback=CUDA_PACKED,
          payload=("packed",))
def _spike_matmul_packed_pipe(s, w, occupancy=None, packed_k=None):
    from repro_torch.kernels import ops
    return ops.spike_matmul_packed(s, w, packed_k=packed_k,
                                   occupancy=occupancy, pipeline=True)


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
    # overlap tile, so the group size must divide the 128-row tile (as
    # `repro`'s `_apec_csr_supports`; g = 1 included).
    del kwargs
    reason = _apec_divisibility(s, w, g=g)
    if reason is None and 128 % g:
        reason = f"group {g} does not divide the 128-row tile"
    return reason


@register("apec_matmul", CUDA, platforms=("cuda",), priority=20,
          supports=_apec_csr_supports, vjp=_matmul_bwd, fallback=CUDA_PRED)
def _apec_matmul_csr(s, w, *, g=2, occupancy=None):
    # Fused event-compacted APEC: union work list, overlap partial sums
    # added into the g member rows in-kernel. A carried map IS the union
    # gate (an s tile is occupied iff its res or ov tile is).
    from repro_torch.kernels import ops
    return ops.apec_matmul_csr(s, w, g=g, occupancy=occupancy)


@register("apec_matmul", CUDA_PACKED, platforms=("cuda",), priority=30,
          supports=_apec_csr_supports, vjp=_matmul_bwd, fallback=CUDA,
          payload=("packed",))
def _apec_matmul_packed(s, w, *, g=2, occupancy=None, packed_k=None):
    # The fused kernel on words end to end: decompose on the words, union
    # work list, both operands' word tiles unpacked on chip.
    from repro_torch.kernels import ops
    return ops.apec_matmul_packed(s, w, g=g, packed_k=packed_k,
                                  occupancy=occupancy)


# The pipelined fused kernels rank above the serial ones, as `repro`'s
# pallas-csr-pipe (26) and packed-csr-pipe (31) above pallas-csr (25) and
# packed-csr (30) for `apec_matmul`.
@register("apec_matmul", CUDA_PIPE, platforms=("cuda",), priority=26,
          supports=_apec_csr_supports, vjp=_matmul_bwd, fallback=CUDA)
def _apec_matmul_csr_pipe(s, w, *, g=2, occupancy=None):
    from repro_torch.kernels import ops
    return ops.apec_matmul_csr(s, w, g=g, occupancy=occupancy, pipeline=True)


@register("apec_matmul", CUDA_PACKED_PIPE, platforms=("cuda",), priority=31,
          supports=_apec_csr_supports, vjp=_matmul_bwd, fallback=CUDA_PACKED,
          payload=("packed",))
def _apec_matmul_packed_pipe(s, w, *, g=2, occupancy=None, packed_k=None):
    from repro_torch.kernels import ops
    return ops.apec_matmul_packed(s, w, g=g, packed_k=packed_k,
                                  occupancy=occupancy, pipeline=True)


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


# ----------------------------------------------------------- causal_sdsa
# The LM's attention: (T, ..., N, d) spikes, status accumulated over
# micro-steps and tokens j <= i (a prefix-OR).
def _causal_sdsa_example(dev):
    return tuple(_binary((2, 2, 2, 12, 40), 0.4, dev, seed=i)
                 for i in range(3)), {"mode": "or"}


register_op("causal_sdsa", _causal_sdsa_example)


def _causal_or_only(q, k, v, *, mode="or") -> Optional[str]:
    del q, k, v
    if mode != "or":
        return f"packed causal path supports mode='or' only, got {mode!r}"
    return None


@register("causal_sdsa", REF, priority=0, differentiable=True)
def _causal_sdsa_ref(q, k, v, *, mode="or"):
    from repro_torch.core.sdsa import causal_sdsa_jnp
    return causal_sdsa_jnp(q, k, v, mode=mode)


@register("causal_sdsa", "jnp", priority=5, auto=False,
          supports=_causal_or_only, vjp=REF)
def _causal_sdsa_packed(q, k, v, *, mode="or"):
    from repro_torch.core.sdsa import causal_sdsa_packed_jnp
    return causal_sdsa_packed_jnp(q, k, v, mode=mode)


@register("causal_sdsa", CUDA, platforms=("cuda",), priority=20,
          supports=_causal_or_only, vjp=REF)
def _causal_sdsa_cuda(q, k, v, *, mode="or"):
    del mode
    from repro_torch.kernels import ops
    return ops.causal_sdsa_or(q, k, v)


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


@register("econv", CUDA, platforms=("cuda",), priority=20, vjp=REF,
          fallback=CUDA_PRED)
def _econv_cuda(s, w, *, stride=1, padding="SAME", occupancy=None):
    from repro_torch.kernels import ops
    return _econv_im2col(s, w, stride, padding, ops.spike_matmul_csr,
                         occupancy)


@register("econv", CUDA_PACKED, platforms=("cuda",), priority=30, vjp=REF,
          fallback=CUDA, payload=("packed",))
def _econv_packed(s, w, *, stride=1, padding="SAME", occupancy=None,
                  packed_k=None):
    # Word-domain im2col (strided slices of the padded words) + the packed
    # CSR kernel; `ops.econv_packed` relays the weights to the patch
    # feature order.
    from repro_torch.kernels import ops
    return ops.econv_packed(s, w, stride=stride, padding=padding,
                            packed_k=packed_k, occupancy=occupancy)


@register("econv", CUDA_PIPE, platforms=("cuda",), priority=26, vjp=REF,
          fallback=CUDA)
def _econv_pipe(s, w, *, stride=1, padding="SAME", occupancy=None):
    from repro_torch.kernels import ops
    return _econv_im2col(s, w, stride, padding, functools.partial(
        ops.spike_matmul_csr, pipeline=True), occupancy)


@register("econv", CUDA_PACKED_PIPE, platforms=("cuda",), priority=31,
          vjp=REF, fallback=CUDA_PACKED, payload=("packed",))
def _econv_packed_pipe(s, w, *, stride=1, padding="SAME", occupancy=None,
                       packed_k=None):
    from repro_torch.kernels import ops
    return ops.econv_packed(s, w, stride=stride, padding=padding,
                            packed_k=packed_k, occupancy=occupancy,
                            pipeline=True)


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


# ---------------------------------------------------------------- hybrid
# The bodies of a hybrid call on a CUDA map (`_hybrid_device_fn`): both
# routes of the pair behind the flags `ops.hybrid_route` computes on the
# card from the map, with each op's gradient rule (the pair's own).
def _spike_matmul_hybrid(s, w, occupancy=None, *, threshold):
    from repro_torch.kernels import ops
    return ops.spike_matmul_hybrid(
        s, w, occupancy=occupancy,
        route=ops.hybrid_route(occupancy, threshold))


def _apec_matmul_hybrid(s, w, *, g=2, occupancy=None, threshold):
    from repro_torch.kernels import ops
    return ops.apec_matmul_hybrid(
        s, w, g, occupancy=occupancy,
        route=ops.hybrid_route(occupancy, threshold))


def _econv_hybrid(s, w, *, stride=1, padding="SAME", occupancy=None,
                  threshold):
    from repro_torch.kernels import ops
    route = ops.hybrid_route(occupancy, threshold)
    return _econv_im2col(s, w, stride, padding, functools.partial(
        ops.spike_matmul_hybrid, route=route), occupancy)


_HYBRID_BODIES = {"spike_matmul": (_spike_matmul_hybrid, _matmul_bwd),
                  "apec_matmul": (_apec_matmul_hybrid, _matmul_bwd),
                  "econv": (_econv_hybrid, REF)}


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


def causal_sdsa(q, k, v, *, mode="or"):
    from repro_torch.core.events import as_spikes
    return dispatch("causal_sdsa", as_spikes(q), as_spikes(k), as_spikes(v),
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
