"""Guarded execution and the event fault classes: repro_torch against
repro, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
injectors (`runtime.faults`) must give the reference's corrupted values
and coordinates for the same seeds, and `FAULT_CLASSES` its tuple. The
guard policy (`kernels.dispatch`: `use_guard`, `guard_mode`,
`EXSPIKE_GUARD`, `watch_guard_events`, `GuardViolationError`) is held to
repro's on host maps (its concrete semantics: audit raises, repair runs
`ref` on the payload) with the same error text and the same record kinds
and actions: every undercount and bit flip flagged, dense and packed; no
flag on valid or overcounted maps, with outputs identical to the
unguarded call; repaired outputs within 1e-5 of repro's and weight
gradients within 1e-5 of `jax.grad`'s; the grid check raising in audit,
econv included; `off` an exact passthrough with unchanged attribution.

A map on the card takes the device semantics (repro's traced ones: audit
NaN-poisons, repair launches kernel 10 behind the violation flag). It is
reached here by reading the maps as device maps (`_device_routed`) with
automatic selection as on the card (`_platform`), the gated wrappers
running their plain versions; held to repro's jitted guard. Small
SpikingFormer and VGG11 forwards, dense and packed, run under audit with
no record and equal the unguarded forwards bit for bit.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SpikingConfig as JSpikingConfig
from repro.configs.registry import paper_cnn_configs as jpaper_cnn_configs
from repro.core import spikes as jspk
from repro.kernels import dispatch as jd
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro.models import spikingformer as jsf
from repro.runtime import faults as jfaults
from repro_torch.configs.base import SpikingConfig
from repro_torch.configs.registry import paper_cnn_configs
from repro_torch.core import spikes as tspk
from repro_torch.kernels import dispatch as td
from repro_torch.kernels import ops as tops
from repro_torch.models import cnn as tcnn
from repro_torch.models import spikingformer as tsf
from repro_torch.models.layers import params_from_numpy
from repro_torch.runtime import faults as tfaults

torch.set_num_threads(1)
ATOL = 1e-5
M, K, N = 256, 256, 64
OPS = ("spike_matmul", "apec_matmul")


@pytest.fixture(autouse=True)
def _fresh_guard_state(monkeypatch):
    monkeypatch.delenv(td.GUARD_ENV_VAR, raising=False)
    monkeypatch.delenv(td.ENV_VAR, raising=False)
    td.reset_fallback_warnings()
    jd.reset_fallback_warnings()
    yield
    td.reset_fallback_warnings()
    jd.reset_fallback_warnings()


@pytest.fixture
def on_card(monkeypatch):
    """Maps read as card maps (the device semantics) and automatic
    selection as on the card; the kernel wrappers run their plain
    versions on the CPU tensors."""
    monkeypatch.setattr(td, "_device_routed", lambda occ: True)
    monkeypatch.setattr(td, "_platform", lambda args: "cuda")


def _spikes(seed=0, density=0.05, m=M, k=K):
    rng = np.random.default_rng(seed)
    return (rng.random((m, k)) < density).astype(np.float32)


def _weights(seed=1, k=K, n=N):
    return np.random.default_rng(seed).standard_normal((k, n)) \
        .astype(np.float32)


def _packed_case(seed=0):
    """Spikes with the upper half of K empty (a bit flip there lands in a
    map-empty tile, the detectable class), their map and their words."""
    s = _spikes(seed)
    s[:, K // 2:] = 0.0
    occ = np.array(jops.padded_occupancy(jnp.asarray(s)))
    words = np.array(jspk.pack_spikes(jnp.asarray(s)))
    return s, occ, words


def _flip_upper_half(words, n_bits, seed):
    half = words.shape[-1] // 2
    sub, flips = jfaults.flip_packed_bits(words[:, half:], n_bits=n_bits,
                                          seed=seed)
    bad = words.copy()
    bad[:, half:] = sub
    return bad, flips


def _twords(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32)) \
        .view(torch.uint32)


def _payload(s, words, packed):
    """(port payload, reference payload, extra kwargs) of one call."""
    if packed:
        return _twords(words), jnp.asarray(words), {"packed_k": K}
    return torch.from_numpy(s), jnp.asarray(s), {}


def _static(op):
    return {"g": 2} if op == "apec_matmul" else {}


def _tcall(op, s, w, occ, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return td.dispatch(op, s, w, occupancy=occ, **_static(op), **kw)


def _jcall(op, s, w, occ, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return jd.dispatch(op, s, w, occupancy=occ, **_static(op), **kw)


def _jtraced(mode, op, s, w, occ, **kw):
    """repro's guard on a traced map (jit traced under `mode`), its
    counterpart of a map on the card."""
    fn = jax.jit(lambda ss, ww, oo: _jcall(op, ss, ww, oo, **kw))
    with jd.use_guard(mode):
        return np.asarray(fn(s, w, jnp.asarray(occ)))


def _events(records):
    return [(e["op"], e["kind"], e["mode"], e["action"]) for e in records]


# --------------------------------------------------------------- injectors
def test_fault_classes_equal_the_reference():
    assert tfaults.FAULT_CLASSES == jfaults.FAULT_CLASSES
    assert tfaults.GuardViolationError is td.GuardViolationError
    assert issubclass(td.GuardViolationError, ValueError)


@pytest.mark.parametrize("seed,n_tiles", [(0, 1), (1, 2), (2, 4), (3, 99)])
def test_undercount_matches_the_reference(seed, n_tiles):
    occ = np.array(jops.padded_occupancy(
        jnp.asarray(_spikes(seed, 0.02, 512, 384))))
    want, want_c = jfaults.undercount_occupancy(occ, n_tiles, seed=seed)
    got, got_c = tfaults.undercount_occupancy(torch.from_numpy(occ), n_tiles,
                                              seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got_c == want_c and all(got[c] == 0 for c in got_c)
    with pytest.raises(ValueError, match="no occupied"):
        tfaults.undercount_occupancy(np.zeros((2, 2), np.int32))


@pytest.mark.parametrize("seed,n_tiles,density", [(0, 1, 0.002), (1, 3, 0.002),
                                                  (2, 2, 0.9)])
def test_overcount_matches_the_reference(seed, n_tiles, density):
    occ = np.array(jops.padded_occupancy(
        jnp.asarray(_spikes(seed, density, 512, 384))))
    want, want_c = jfaults.overcount_occupancy(occ, n_tiles, seed=seed)
    got, got_c = tfaults.overcount_occupancy(torch.from_numpy(occ), n_tiles,
                                             seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got_c == want_c
    assert (got >= occ).all()            # still an upper bound


@pytest.mark.parametrize("seed,n_bits", [(0, 1), (1, 4), (5, 17)])
def test_flip_packed_bits_matches_the_reference(seed, n_bits):
    _, _, words = _packed_case(seed)
    want, want_f = jfaults.flip_packed_bits(words, n_bits, seed=seed)
    got, got_f = tfaults.flip_packed_bits(_twords(words), n_bits, seed=seed)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert got_f == want_f
    assert ((got & words) == words).all()    # 0 -> 1 only
    with pytest.raises(ValueError, match="uint32"):
        tfaults.flip_packed_bits(words.astype(np.int64))


@pytest.mark.parametrize("kw,match", [({"tiling": (64, 64)}, "tiling"),
                                      ({"tiling": None, "map_shape": (9, 9)},
                                       "tile grid")])
def test_stale_csr_is_rejected_by_check_compatible(kw, match):
    s = _spikes(8)
    tcsr = tspk.occupancy_to_csr(tops.padded_occupancy(torch.from_numpy(s)),
                                 tiling=(128, 128))
    jcsr = jspk.occupancy_to_csr(jops.padded_occupancy(jnp.asarray(s)),
                                 tiling=(128, 128))
    mt, kt = M // 128, K // 128
    for faults, csr in ((tfaults, tcsr), (jfaults, jcsr)):
        bad = faults.stale_csr(csr, **kw)
        with pytest.raises(ValueError, match=match):
            bad.check_compatible(128, 128, mt, kt)
    tcsr.check_compatible(128, 128, mt, kt)          # the fresh one passes


# ------------------------------------------------------------ mode, env
@pytest.mark.parametrize("value", ["audit", " Repair ", "off", ""])
def test_guard_mode_reads_the_env_as_the_reference(monkeypatch, value):
    monkeypatch.setenv(td.GUARD_ENV_VAR, value)
    monkeypatch.setenv(jd.GUARD_ENV_VAR, value)
    assert td.GUARD_ENV_VAR == jd.GUARD_ENV_VAR == "EXSPIKE_GUARD"
    assert td.GUARD_MODES == jd.GUARD_MODES
    assert td.GUARDED_OPS == jd.GUARDED_OPS
    assert td.guard_mode() == jd.guard_mode()
    with td.use_guard("audit"):                  # the context wins
        assert td.guard_mode() == "audit"


@pytest.mark.parametrize("how", ["env", "context"])
def test_bad_modes_raise_the_reference_text(monkeypatch, how):
    texts = []
    for mod in (td, jd):
        with pytest.raises(ValueError, match="bogus") as err:
            if how == "env":
                monkeypatch.setenv(mod.GUARD_ENV_VAR, "bogus")
                mod.guard_mode()
            else:
                with mod.use_guard("bogus"):
                    pass
        texts.append(str(err.value))
    assert texts[0] == texts[1]


# ------------------------------------------------ host maps: audit, repair
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("seed,n_tiles", [(0, 1), (1, 2), (2, 4)])
def test_audit_flags_every_undercount_dense(op, seed, n_tiles):
    s, w = _spikes(seed), _weights()
    occ = np.asarray(jops.padded_occupancy(jnp.asarray(s)))
    bad, coords = tfaults.undercount_occupancy(occ, n_tiles, seed=seed)
    assert coords
    records = []
    for mod, cast, call in ((td, torch.from_numpy, _tcall),
                            (jd, jnp.asarray, _jcall)):
        with mod.use_guard("audit"), mod.watch_guard_events() as ev:
            with pytest.raises(mod.GuardViolationError, match="undercount"):
                call(op, cast(s), cast(w), cast(bad))
        records.append(_events(ev))
    assert records[0] == records[1] == [(op, "undercount", "audit", "raise")]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("fault", ["undercount", "bitflip"])
def test_audit_flags_packed_faults(op, fault):
    s, occ, words = _packed_case(1)
    w = _weights()
    if fault == "undercount":
        occ, _ = tfaults.undercount_occupancy(occ, 1, seed=1)
    else:
        words, flips = _flip_upper_half(words, 3, seed=1)
        assert flips
    records = []
    for mod, ws, cast, call in ((td, _twords(words), torch.from_numpy,
                                 _tcall),
                                (jd, jnp.asarray(words), jnp.asarray,
                                 _jcall)):
        with mod.use_guard("audit"), mod.watch_guard_events() as ev:
            with pytest.raises(mod.GuardViolationError):
                call(op, ws, cast(w), cast(occ), packed_k=K)
        records.append(_events(ev))
    assert records[0] == records[1] == [(op, "undercount", "audit", "raise")]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("overcount", [False, True])
def test_valid_and_overcounted_maps_never_flag(op, packed, overcount):
    s, occ, words = _packed_case(4)
    w = torch.from_numpy(_weights())
    if overcount:
        occ, coords = tfaults.overcount_occupancy(occ, 2, seed=4)
        assert coords
    ts, _, kw = _payload(s, words, packed)
    occ = torch.from_numpy(occ)
    base = _tcall(op, ts, w, occ, **kw)
    for mode in ("audit", "repair"):
        with td.use_guard(mode), td.watch_guard_events() as ev:
            out = _tcall(op, ts, w, occ, **kw)
        assert ev == []
        assert torch.equal(out, base)
    np.testing.assert_allclose(base.numpy(), s @ _weights(), atol=ATOL)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("seed", [5, 6])
def test_repair_matches_the_reference(op, seed):
    s, w = _spikes(seed, 0.1), _weights()
    occ = np.asarray(jops.padded_occupancy(jnp.asarray(s)))
    bad, _ = tfaults.undercount_occupancy(occ, 3, seed=seed)
    outs, records = [], []
    for mod, cast, call in ((td, torch.from_numpy, _tcall),
                            (jd, jnp.asarray, _jcall)):
        with mod.use_guard("repair"), mod.watch_guard_events() as ev:
            outs.append(np.asarray(call(op, cast(s), cast(w), cast(bad))))
        records.append(_events(ev))
        assert ev[0]["attribution"].endswith("+repaired")
    np.testing.assert_allclose(outs[0], outs[1], atol=ATOL)
    np.testing.assert_allclose(outs[0], s @ w, atol=ATOL)
    assert records[0] == records[1] == [(op, "undercount", "repair",
                                         "repair")]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("path", ["host", "device"])
def test_repair_gradient_matches_jax_grad(request, op, path):
    if path == "device":
        request.getfixturevalue("on_card")
    s, w = _spikes(6, 0.1), _weights()
    bad, _ = tfaults.undercount_occupancy(
        np.asarray(jops.padded_occupancy(jnp.asarray(s))), 2, seed=6)
    with jd.use_guard("repair"):
        want = jax.grad(lambda ww: jnp.sum(_jcall(
            op, jnp.asarray(s), ww, jnp.asarray(bad)) ** 2))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    with td.use_guard("repair"):
        out = _tcall(op, torch.from_numpy(s), wt, torch.from_numpy(bad))
    (got,) = torch.autograd.grad((out ** 2).sum(), [wt])
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= ATOL * float(np.abs(want).max()) + ATOL, err


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("path", ["host", "device"])
def test_packed_repair_is_the_corrupted_payloads_product(request, op, path):
    if path == "device":
        request.getfixturevalue("on_card")
    s, occ, words = _packed_case(2)
    w = _weights()
    bad, _ = _flip_upper_half(words, 2, seed=2)
    s_bad = np.asarray(jspk.unpack_spikes(jnp.asarray(bad),
                                          dtype=jnp.float32))[:, :K]
    with td.use_guard("repair"), td.watch_guard_events() as ev:
        out = _tcall(op, _twords(bad), torch.from_numpy(w),
                     torch.from_numpy(occ), packed_k=K)
    assert _events(ev) == [(op, "undercount", "repair", "repair")]
    assert ev[0].get("traced", False) == (path == "device")
    # The map is dropped and nothing silently zeroed: the corrupted
    # payload's product, which differs from the clean one.
    np.testing.assert_allclose(out.numpy(), s_bad @ w, atol=ATOL)
    assert not np.allclose(out.numpy(), s @ w, atol=ATOL)


# ------------------------------------------------------------ grid check
def _wrong_grid_case(op):
    """(args, kwargs) of a call whose map is on a wrong grid."""
    if op == "econv":
        s = (np.random.default_rng(7).random((2, 8, 8, 6)) < 0.3) \
            .astype(np.float32)
        w = _weights(k=3 * 3 * 6, n=10).reshape(3, 3, 6, 10)
        return (s, w), {"stride": 1, "padding": "SAME"}
    return (_spikes(7), _weights()), _static(op)


@pytest.mark.parametrize("op", td.GUARDED_OPS)
@pytest.mark.parametrize("path", ["host", "device"])
def test_wrong_grid_raises_in_audit(request, op, path):
    if path == "device":
        request.getfixturevalue("on_card")
    args, static = _wrong_grid_case(op)
    texts = []
    for mod, cast in ((td, torch.from_numpy), (jd, jnp.asarray)):
        stale = cast(np.zeros((3, 3), np.int32))   # wrong grid for both
        with mod.use_guard("audit"), mod.watch_guard_events() as ev, \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with pytest.raises(mod.GuardViolationError, match="grid") as err:
                mod.dispatch(op, *map(cast, args), occupancy=stale, **static)
        texts.append(str(err.value).split(": ", 1)[1])
        assert _events(ev) == [(op, "grid", "audit", "raise")]
    assert texts[0] == texts[1]


@pytest.mark.parametrize("op", td.GUARDED_OPS)
@pytest.mark.parametrize("path", ["host", "device"])
def test_wrong_grid_repairs_on_the_payload(request, op, path):
    if path == "device":
        request.getfixturevalue("on_card")
    args, static = _wrong_grid_case(op)
    with jd.use_guard("repair"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = np.asarray(jd.dispatch(op, *map(jnp.asarray, args),
                                      occupancy=jnp.zeros((3, 3), jnp.int32),
                                      **static))
    with td.use_guard("repair"), td.watch_guard_events() as ev, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = td.dispatch(op, *map(torch.from_numpy, args),
                          occupancy=torch.zeros((3, 3), dtype=torch.int32),
                          **static)
    assert _events(ev) == [(op, "grid", "repair", "repair")]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("op,kind", [(op, "grid") for op in td.GUARDED_OPS]
                         + [(op, "undercount") for op in OPS])
def test_card_payload_with_a_host_map_repairs_on_a_kernel_route(
        card_routing, monkeypatch, op, kind):
    """A payload on the card whose map is on the host: the flag is read on
    the host (the map is there), but the trusted route is the payload's
    platform's, `cuda-pred`, never `ref` running on card tensors."""
    if kind == "grid":
        (s, w), static = _wrong_grid_case(op)
        occ = np.zeros((3, 3), np.int32)
    else:
        s, w, static = _spikes(7), _weights(), _static(op)
        occ, _ = tfaults.undercount_occupancy(
            np.asarray(tops.padded_occupancy(torch.from_numpy(s))), 1, seed=7)
    taken = []
    for name in (td.REF, td.CUDA_PRED):
        be = td._REGISTRY[op].backends[name]

        def spy(*a, _fn=be.fn, _name=name, **kw):
            taken.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setitem(td._REGISTRY[op].backends, name,
                            dataclasses.replace(be, fn=spy))
    with jd.use_guard("repair"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = np.asarray(jd.dispatch(op, *map(jnp.asarray, (s, w)),
                                      occupancy=jnp.asarray(occ), **static))
    with td.use_guard("repair"), td.watch_guard_events() as ev, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = td.dispatch(op, torch.from_numpy(s), torch.from_numpy(w),
                          occupancy=torch.from_numpy(occ), **static)
    assert taken == [td.CUDA_PRED]
    assert _events(ev) == [(op, kind, "repair", "repair")]
    assert not ev[0].get("traced", False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


# ------------------------------------------------------------------ off
@pytest.mark.parametrize("op", td.GUARDED_OPS)
@pytest.mark.parametrize("path", ["host", "device"])
def test_off_is_an_exact_passthrough(request, op, path):
    if path == "device":
        request.getfixturevalue("on_card")
    if op == "econv":
        from repro_torch.core.events import EventTensor, conv_patch_occupancy
        (s, w), static = _wrong_grid_case(op)
        s, w = torch.from_numpy(s), torch.from_numpy(w)
        occ = conv_patch_occupancy(EventTensor.from_spikes(s), w.shape, 1,
                                   "SAME")
    else:
        s, w = torch.from_numpy(_spikes(9)), torch.from_numpy(_weights())
        static, occ = _static(op), tops.padded_occupancy(s)
    base_be, base = td.resolve_with_attribution(op, s, w, occupancy=occ,
                                                **static)
    plain = base_be.fn(s, w, occupancy=occ, **static)
    assert td.guard_mode() == "off"
    for mode in ("off",) + td.GUARD_MODES[1:]:
        with td.use_guard(mode), td.watch_resolutions() as rec:
            be, attr = td.resolve_with_attribution(op, s, w, occupancy=occ,
                                                   **static)
            out = be.fn(s, w, occupancy=occ, **static)
        assert attr == base and be.name == base_be.name  # policy, not routing
        assert rec[0]["attribution"] == base
        assert torch.equal(out, plain)
        assert (be is base_be or be.fn is base_be.fn) == (mode == "off")


# ------------------------------------------------ card maps: the device body
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("packed", [False, True])
def test_device_audit_poisons_and_records_only_when_watched(on_card, op,
                                                            packed):
    s, occ, words = _packed_case(3)
    w = _weights()
    bad, _ = tfaults.undercount_occupancy(occ, 1, seed=3)
    ts, js, kw = _payload(s, words, packed)
    want = _jtraced("audit", op, js, jnp.asarray(w), bad, **kw)
    assert np.isnan(want).all()
    with td.use_guard("audit"):
        out = _tcall(op, ts, torch.from_numpy(w), torch.from_numpy(bad), **kw)
        with td.watch_guard_events() as ev:
            watched = _tcall(op, ts, torch.from_numpy(w),
                             torch.from_numpy(bad), **kw)
            clean = _tcall(op, ts, torch.from_numpy(w),
                           torch.from_numpy(occ), **kw)
    assert bool(out.isnan().all()) and bool(watched.isnan().all())
    assert [(e["kind"], e["action"], e["traced"]) for e in ev] == \
        [("undercount", "record", True)]
    assert torch.equal(clean, _tcall(op, ts, torch.from_numpy(w),
                                     torch.from_numpy(occ), **kw))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("packed", [False, True])
def test_device_repair_matches_the_reference_traced(on_card, op, packed):
    s, occ, words = _packed_case(5)
    w = _weights()
    bad, _ = tfaults.undercount_occupancy(occ, 2, seed=5)
    ts, js, kw = _payload(s, words, packed)
    want = _jtraced("repair", op, js, jnp.asarray(w), bad, **kw)
    with td.use_guard("repair"), td.watch_guard_events() as ev:
        got = _tcall(op, ts, torch.from_numpy(w), torch.from_numpy(bad), **kw)
    clean = _tcall(op, ts, torch.from_numpy(w), torch.from_numpy(occ), **kw)
    unguarded = _tcall(op, ts, torch.from_numpy(w), torch.from_numpy(bad),
                       **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), clean.numpy(), atol=ATOL)
    assert not np.allclose(unguarded.numpy(), clean.numpy(), atol=ATOL)
    assert [(e["action"], e["traced"]) for e in ev] == [("repair", True)]
    assert ev[0]["attribution"] == \
        td.resolve_name(op, ts, torch.from_numpy(w),
                        occupancy=torch.from_numpy(occ), **_static(op), **kw) \
        + "+repaired"


@pytest.mark.parametrize("flag", [0, 1])
def test_guard_repair_writes_only_where_flagged(flag):
    """`ops.guard_repair` on CPU tensors: kernel 10's plain version on the
    payload with its support map, written over `out` only where the flag
    is set; a non-f32 `out` is selected with `torch.where`."""
    s = torch.from_numpy(_spikes(3, 0.1))
    w = torch.from_numpy(_weights())
    support = tops.support_map(s)
    f = torch.tensor([flag], dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        out = torch.full((M, N), 7.0, dtype=dtype)
        got = tops.guard_repair(s, w, support, f, out)
        want = (s @ w).to(dtype) if flag else torch.full_like(out, 7.0)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=ATOL)
        assert (got is out) == (dtype == torch.float32)


@pytest.mark.parametrize("packed", [False, True])
def test_support_map_is_the_payloads_own_map(packed):
    s = _spikes(2, 0.01, 300, 200)
    want = np.asarray(jops.padded_occupancy(jnp.asarray(s)))
    if packed:
        got = tops.support_map(tspk.pack_spikes_padded(torch.from_numpy(s)),
                               200)
    else:
        got = tops.support_map(torch.from_numpy(s).reshape(3, 100, 200))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- models
def _sf_run(packed):
    jp = jsf.spikingformer_init(jax.random.PRNGKey(0), 1, 32)
    x = np.random.default_rng(1).random((2, 32, 32, 3), dtype=np.float32)
    params = tsf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")
    cfg = SpikingConfig(t_steps=2, lif_vth=1.0, packed=packed)

    def run():
        return tsf.spikingformer_apply(params, torch.from_numpy(x), n_heads=4,
                                       spiking_cfg=cfg, collect_stats=True)
    jlogits, _ = jsf.spikingformer_apply(
        jp, jnp.asarray(x), n_heads=4,
        spiking_cfg=JSpikingConfig(t_steps=2, lif_vth=1.0, packed=packed),
        collect_stats=True)
    return run, np.asarray(jlogits)


def _vgg_run(packed):
    jcfg = dataclasses.replace(
        jpaper_cnn_configs()["vgg11"], img=32,
        spiking=JSpikingConfig(t_steps=2, lif_vth=0.5, packed=packed))
    tcfg = dataclasses.replace(
        paper_cnn_configs()["vgg11"], img=32,
        spiking=SpikingConfig(t_steps=2, lif_vth=0.5, packed=packed))
    jp = jcnn.vgg11_init(jcfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(4).random((2, 32, 32, 3), dtype=np.float32)
    params = params_from_numpy(jp, device="cpu")

    def run():
        return tcnn.vgg11_apply(tcfg, params, torch.from_numpy(x),
                                collect_stats=True)
    return run, np.asarray(jcnn.vgg11_apply(jcfg, jp, jnp.asarray(x)))


@pytest.mark.parametrize("model", ["spikingformer", "vgg11"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("path", ["host", "device"])
def test_model_forward_under_audit_equals_unguarded(request, model, packed,
                                                    path):
    request.getfixturevalue("on_card" if path == "device" else "card_routing")
    run, jlogits = (_sf_run if model == "spikingformer" else _vgg_run)(packed)
    with torch.inference_mode():
        base_logits, base_stats = run()
        with td.use_guard("audit"), td.watch_guard_events() as ev, \
                td.watch_resolutions() as rec:
            logits, stats = run()
    guarded = [r["op"] for r in rec
               if r["op"] in td.GUARDED_OPS]
    assert guarded, "no guarded call in the forward"
    assert ev == []
    assert torch.equal(logits, base_logits)
    assert len(stats) == len(base_stats)
    assert all(torch.equal(a, b) for a, b in zip(stats, base_stats))
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=1e-4)


@pytest.fixture
def card_routing(monkeypatch):
    """Automatic selection as on the card, the maps on the host."""
    monkeypatch.setattr(td, "_platform", lambda args: "cuda")
