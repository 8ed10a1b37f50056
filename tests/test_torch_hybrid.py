"""Hybrid dense/event dispatch: repro_torch against repro, on the CPU.

Both packages get the same calibration (monkeypatched tables, fit on the
same tile grid, caches cleared): the port's H100 sweep, or repro's own
BENCH_PR3 table, whose threshold sits inside the small grids used here so
that both routes are reached. For `spike_matmul`, `apec_matmul` (g = 2)
and `econv`, a map in every pow2 bucket of three (mt, kt) grids must get
repro's route and attribution, with `pallas-csr-interpret` read as `cuda`
and `pallas-interpret` as `cuda-pred`; the routes' forwards match repro's
within 1e-5 (fp32 summation order), and the weights' gradients on both
sides of the threshold within 1e-5 of their largest element. A map on the card takes the device
path (`hybrid[cuda|cuda-pred@b<t>]`, repro's traced `lax.cond`); it is
reached here by reading the maps as device maps (`_device_routed`), the
gated wrappers then running their plain versions. Models under
`SpikingConfig(hybrid=True)` equal the automatic forward bit for bit with
selection as on the card, and repro's forward within the model tests'
tolerance (logits 1e-5, spike maps exact).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import SpikingConfig as JSpikingConfig
from repro.core import costmodel as jcm
from repro.core import spikes as jspikes
from repro.kernels import dispatch as jd
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro.models import spikingformer as jsf
from repro_torch.configs.base import SpikingConfig
from repro_torch.configs.registry import paper_cnn_configs
from repro_torch.core import costmodel as tcm
from repro_torch.core import spikes as tspikes
from repro_torch.core.spikes import pack_spikes_padded
from repro_torch.kernels import dispatch as td
from repro_torch.kernels import ops as tops
from repro_torch.models import cnn as tcnn
from repro_torch.models import spikingformer as tsf
from repro_torch.models.layers import params_from_numpy

torch.set_num_threads(1)
ATOL = 1e-5
NAMES = {"pallas-csr-interpret": "cuda", "pallas-interpret": "cuda-pred"}
GRIDS = [(2, 2), (2, 3), (4, 4)]
OPS = ("spike_matmul", "apec_matmul", "econv")
CASES = [(op, grid, b) for op in OPS for grid in GRIDS
         for b in range(tcm.num_buckets(grid[0] * grid[1]))]


def _case_id(c):
    return "%s-%dx%d-b%d" % (c[0], *c[1], c[2])


def _grad_close(got, want):
    """Gradients within 1e-5 * max|want| + 1e-5: each weight's cotangent
    sums hundreds of rows, in another order in each package, so a small
    element carries the rounding of the large sum around it."""
    err = float(np.abs(got - want).max())
    assert err <= ATOL * float(np.abs(want).max()) + ATOL, err


def _mapped(attr: str) -> str:
    for jname, tname in NAMES.items():
        attr = attr.replace(jname, tname)
    return attr


@pytest.fixture(autouse=True)
def _fresh_dispatch_state(monkeypatch):
    monkeypatch.delenv(td.ENV_VAR, raising=False)
    td.reset_fallback_warnings()
    jd.reset_fallback_warnings()


def _calibrate(monkeypatch, points, grid):
    for op in ("spike_matmul", "apec_matmul"):
        monkeypatch.setitem(jcm.ROUTE_CALIBRATION_POINTS, op, points[op])
        monkeypatch.setitem(tcm.ROUTE_CALIBRATION_POINTS, op, points[op])
    monkeypatch.setattr(jcm.fit_route_params, "__defaults__", grid)
    monkeypatch.setattr(tcm.fit_route_params, "__defaults__", grid)
    jcm.calibrated_route_params.cache_clear()
    tcm.calibrated_route_params.cache_clear()


@pytest.fixture(params=["h100", "bench_pr3"])
def calibration(request, monkeypatch):
    """Both packages on one calibration: the port's H100 sweep on its grid,
    or repro's BENCH_PR3 table on repro's 4 x 4 grid."""
    if request.param == "h100":
        points = dict(tcm.ROUTE_CALIBRATION_POINTS)
        grid = (tcm.CALIBRATION_TILES_M, tcm.CALIBRATION_TILES_K)
    else:
        points = dict(jcm.ROUTE_CALIBRATION_POINTS)
        grid = (jcm.CALIBRATION_TILES_M, jcm.CALIBRATION_TILES_K)
    _calibrate(monkeypatch, points, grid)
    yield request.param
    jcm.calibrated_route_params.cache_clear()
    tcm.calibrated_route_params.cache_clear()


@pytest.fixture
def bench_calibration(monkeypatch):
    """repro's BENCH_PR3 table on its 4 x 4 grid, in both packages: its
    threshold lies inside the grids here, so both routes are reached."""
    _calibrate(monkeypatch, dict(jcm.ROUTE_CALIBRATION_POINTS),
               (jcm.CALIBRATION_TILES_M, jcm.CALIBRATION_TILES_K))
    yield
    jcm.calibrated_route_params.cache_clear()
    tcm.calibrated_route_params.cache_clear()


def _spikes(mt, kt, n_live, seed=0):
    """(mt*128, kt*128) binary spikes with exactly `n_live` live 128 x 128
    tiles at random places, half dense inside a live tile."""
    rng = np.random.default_rng(seed + 97 * n_live)
    live = np.zeros(mt * kt, bool)
    live[rng.permutation(mt * kt)[:n_live]] = True
    mask = np.kron(live.reshape(mt, kt), np.ones((128, 128), bool))
    return ((rng.random(mask.shape) < 0.5) & mask).astype(np.float32)


def _inputs(op, grid, n_live, seed=0):
    """(args, static kwargs, map) as numpy for `op` on a map of `grid`
    with `n_live` occupied tiles. econv: a 1 x 1 conv, whose patch matrix
    is the spike matrix itself, so its map is the spikes' map."""
    mt, kt = grid
    s = _spikes(mt, kt, n_live, seed)
    occ = np.asarray(jops.padded_occupancy(jnp.asarray(s)))
    assert int((occ > 0).sum()) == n_live
    rng = np.random.default_rng(seed + 1)
    if op == "econv":
        w = (0.05 * rng.standard_normal((1, 1, kt * 128, 16))).astype(
            np.float32)
        return (s.reshape(2, mt * 8, 8, kt * 128), w), \
            {"stride": 1, "padding": "SAME"}, occ
    w = (0.05 * rng.standard_normal((kt * 128, 24))).astype(np.float32)
    return (s, w), ({"g": 2} if op == "apec_matmul" else {}), occ


def _resolve_both(op, args, static, occ):
    jargs = tuple(jnp.asarray(a) for a in args)
    targs = tuple(torch.from_numpy(a) for a in args)
    with jd.use_hybrid():
        jbe, jattr = jd.resolve_with_attribution(
            op, *jargs, occupancy=jnp.asarray(occ), **static)
    with td.use_hybrid():
        tbe, tattr = td.resolve_with_attribution(
            op, *targs, occupancy=torch.from_numpy(occ), **static)
    return (jbe, jargs, jattr), (tbe, targs, tattr)


# ------------------------------------------------------- route parity
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_route_and_attribution_match_jax(calibration, case):
    op, grid, bucket = case
    n_live = tcm.bucket_representative(bucket, grid[0] * grid[1])
    assert tcm.pow2_bucket(n_live) == bucket
    (jbe, _, jattr), (tbe, _, tattr) = _resolve_both(op, *_inputs(
        op, grid, n_live))
    assert tattr == _mapped(jattr)
    assert tbe.name == NAMES[jbe.name]
    assert tattr.endswith(f"<-{td.HYBRID}[b{bucket}]")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_hybrid_forward_matches_jax(bench_calibration, case):
    op, grid, bucket = case
    n_live = tcm.bucket_representative(bucket, grid[0] * grid[1])
    args, static, occ = _inputs(op, grid, n_live)
    (jbe, jargs, jattr), (tbe, targs, tattr) = _resolve_both(
        op, args, static, occ)
    assert tattr == _mapped(jattr)
    want = np.asarray(jbe.fn(*jargs, occupancy=jnp.asarray(occ), **static))
    got = tbe.fn(*targs, occupancy=torch.from_numpy(occ), **static)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def _grads(op, grid, n_live, device_path=False, monkeypatch=None):
    """(port's dw, repro's dw, port attribution, repro attribution) of
    sum(out * cot) through the hybrid route of a map with `n_live`
    occupied tiles."""
    args, static, occ = _inputs(op, grid, n_live, seed=5)
    (jbe, jargs, jattr), (_, targs, tattr) = _resolve_both(
        op, args, static, occ)
    jocc = jnp.asarray(occ)
    out_shape = jbe.fn(*jargs, occupancy=jocc, **static).shape
    cot = np.random.default_rng(7).standard_normal(out_shape).astype(
        np.float32)
    jdw = jax.grad(lambda w: jnp.sum(
        jbe.fn(jargs[0], w, occupancy=jocc, **static) * cot))(jargs[1])
    if device_path:
        monkeypatch.setattr(td, "_device_routed", lambda occ: True)
    w = targs[1].clone().requires_grad_(True)
    with td.use_hybrid():
        tbe, tattr = td.resolve_with_attribution(
            op, targs[0], w, occupancy=torch.from_numpy(occ), **static)
        out = tbe.fn(targs[0], w, occupancy=torch.from_numpy(occ), **static)
    (out * torch.from_numpy(cot)).sum().backward()
    return w.grad.numpy(), np.asarray(jdw), tattr, jattr


@pytest.mark.parametrize("side", ["event", "dense"])
@pytest.mark.parametrize("op", OPS)
def test_hybrid_grad_matches_jax_on_both_sides(bench_calibration, op, side):
    grid = (4, 4)
    thresh = tcm.hybrid_event_bucket_threshold(op, *grid)
    assert 0 <= thresh < tcm.num_buckets(16) - 1
    n_live = (1 << thresh) - 1 if side == "event" else 1 << thresh
    got, want, tattr, jattr = _grads(op, grid, max(n_live, 0))
    assert tattr == _mapped(jattr)
    assert tattr.startswith("cuda<-" if side == "event" else "cuda-pred<-")
    _grad_close(got, want)


# --------------------------------------------------------- device path
def _traced_attribution(op, args, static, occ):
    """repro's attribution and output for a traced map (under jit)."""
    calls = []

    def f(s, w, o):
        with jd.use_hybrid():
            be, attr = jd.resolve_with_attribution(op, s, w, occupancy=o,
                                                   **static)
        calls.append(attr)
        return be.fn(s, w, occupancy=o, **static)
    out = jax.jit(f)(*(jnp.asarray(a) for a in args), jnp.asarray(occ))
    return calls[0], np.asarray(out)


@pytest.mark.parametrize("op", OPS)
def test_device_path_matches_jax_traced_cond(bench_calibration, monkeypatch,
                                             op):
    """A device map resolves to `hybrid[cuda|cuda-pred@b<t>]`, repro's
    traced attribution, and ONE resolution takes its route from the map
    it is called with, as one CUDA graph does at replay: a sparse map and
    a full map through the same backend fn each match repro's cond."""
    monkeypatch.setattr(td, "_device_routed", lambda occ: True)
    grid = (4, 4)
    thresh = tcm.hybrid_event_bucket_threshold(op, *grid)
    resolved = None
    for n_live in ((1 << thresh) - 1, 1 << thresh, 16):
        args, static, occ = _inputs(op, grid, n_live)
        jattr, want = _traced_attribution(op, args, static, occ)
        targs = tuple(torch.from_numpy(a) for a in args)
        tocc = torch.from_numpy(occ)
        with td.use_hybrid():
            tbe, tattr = td.resolve_with_attribution(op, *targs,
                                                     occupancy=tocc, **static)
        assert tattr == _mapped(jattr) == \
            f"{td.HYBRID}[cuda|cuda-pred@b{thresh}]"
        resolved = resolved or tbe
        got = resolved.fn(*targs, occupancy=tocc, **static)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("op", OPS)
def test_device_path_grad_matches_jax(bench_calibration, monkeypatch, op):
    thresh = tcm.hybrid_event_bucket_threshold(op, 4, 4)
    for n_live in ((1 << thresh) - 1, 1 << thresh):
        got, want, tattr, _ = _grads(op, (4, 4), n_live, device_path=True,
                                     monkeypatch=monkeypatch)
        assert tattr == f"{td.HYBRID}[cuda|cuda-pred@b{thresh}]"
        _grad_close(got, want)


@pytest.mark.parametrize("grid", [(4, 4), (64, 12), (1, 32), (1024, 4)])
def test_device_flags_equal_the_host_decision(calibration, grid):
    """`ops.hybrid_route`'s flags, computed from the map without a host
    read, equal the concrete path's decision for random maps."""
    mt, kt = grid
    rng = np.random.default_rng(mt * kt)
    for op in OPS:
        thresh = tcm.hybrid_event_bucket_threshold(op, mt, kt)
        for _ in range(12):
            p = rng.choice([0.0, 0.001, 0.01, 0.1, 0.5, 1.0])
            occ = torch.from_numpy((rng.random((mt, kt)) < p).astype(
                np.int32) * rng.integers(1, 9, (mt, kt)).astype(np.int32))
            count = int((occ > 0).sum())
            bucket = tcm.pow2_bucket(count)
            rep = tcm.bucket_representative(bucket, mt * kt)
            event = tcm.event_route_wins(op, rep, mt, kt)
            flags = tops.hybrid_route(occ, thresh)
            assert flags.dtype == torch.int32
            assert flags.tolist() == [int(event), int(not event)]
            assert bool(tcm.pow2_bucket_traced(
                (occ > 0).sum(), (mt * kt).bit_length()) <= thresh) == event


def test_gated_wrappers_write_only_when_their_flag_is_set():
    """On CPU tensors a gated wrapper's plain version writes `out` only
    where its flag is set, as the kernel does on the card."""
    from repro_torch.kernels import spike_matmul as sm
    s = torch.from_numpy(_spikes(2, 2, 2))
    w = torch.randn(256, 24, generator=torch.Generator().manual_seed(0))
    occ = tops.padded_occupancy(s)
    csr = tspikes.build_csr(occ, 128, 128)
    on, off = torch.tensor([1], dtype=torch.int32), \
        torch.tensor([0], dtype=torch.int32)
    for call in (lambda r, o: sm.spike_matmul_pred(s, w, occ, route=r, out=o),
                 lambda r, o: sm.spike_matmul_csr(s, w, csr, route=r, out=o)):
        ref = call(None, None)
        out = torch.full_like(ref, 7.0)
        assert call(off, out) is out and bool((out == 7.0).all())
        call(on, out)
        assert torch.equal(out, ref)
        with pytest.raises(ValueError, match="writes into `out`"):
            call(on, None)


# -------------------------------------------------------- disengagement
def test_hybrid_disengages_without_a_map_as_jax():
    s = _spikes(2, 2, 2)
    w = np.zeros((256, 64), np.float32)
    with jd.use_hybrid("spike_matmul"):
        jattr = jd.resolve_attribution("spike_matmul", jnp.asarray(s),
                                       jnp.asarray(w))
    with td.use_hybrid("spike_matmul"):
        tattr = td.resolve_attribution("spike_matmul", torch.from_numpy(s),
                                       torch.from_numpy(w))
    assert tattr == jattr == f"{td.REF}<-{td.HYBRID}"


def test_hybrid_scopes_to_the_named_op_only():
    s = _spikes(2, 2, 2)
    w = np.zeros((256, 64), np.float32)
    occ = np.asarray(jops.padded_occupancy(jnp.asarray(s)))
    with jd.use_hybrid("apec_matmul"):
        jattr = jd.resolve_attribution("spike_matmul", jnp.asarray(s),
                                       jnp.asarray(w),
                                       occupancy=jnp.asarray(occ))
    with td.use_hybrid("apec_matmul"):
        tattr = td.resolve_attribution("spike_matmul", torch.from_numpy(s),
                                       torch.from_numpy(w),
                                       occupancy=torch.from_numpy(occ))
    assert td.HYBRID not in tattr and tattr == jattr == td.REF


def test_hybrid_disengages_on_packed_payloads_as_jax():
    s = _spikes(2, 2, 2)
    w = np.zeros((256, 64), np.float32)
    occ = np.asarray(jops.padded_occupancy(jnp.asarray(s)))
    jwords = jspikes.pack_spikes(jnp.asarray(s), axis=-1)
    twords = pack_spikes_padded(torch.from_numpy(s))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with jd.use_hybrid():
            jattr = jd.resolve_attribution(
                "spike_matmul", jwords, jnp.asarray(w),
                occupancy=jnp.asarray(occ), packed_k=256)
        with td.use_hybrid():
            tattr = td.resolve_attribution(
                "spike_matmul", twords, torch.from_numpy(w),
                occupancy=torch.from_numpy(occ), packed_k=256)
    assert tattr == jattr == f"{td.REF}+unpack<-{td.HYBRID}"


def test_resolved_backends_under_hybrid_match_jax():
    with td.use_hybrid():
        trb = td.resolved_backends("cpu")
    with jd.use_hybrid():
        jrb = jd.resolved_backends()
    for op in td.HYBRID_OPS:
        assert trb[op].endswith(f"<-{td.HYBRID}"), trb[op]
        assert trb[op] == jrb[op]
    for op in set(trb) - set(td.HYBRID_OPS):
        assert td.HYBRID not in trb[op]


def test_env_spelling_selects_hybrid(monkeypatch, bench_calibration):
    args, static, occ = _inputs("spike_matmul", (4, 4), 1)
    monkeypatch.setenv(td.ENV_VAR, td.HYBRID)
    attr = td.resolve_attribution(
        "spike_matmul", *(torch.from_numpy(a) for a in args),
        occupancy=torch.from_numpy(occ))
    assert attr == f"cuda<-{td.HYBRID}[b1]"
    monkeypatch.setenv(td.ENV_VAR, f"spike_matmul={td.HYBRID}")
    assert td.resolve_attribution(
        "apec_matmul", *(torch.from_numpy(a) for a in args),
        occupancy=torch.from_numpy(occ), g=2) == "jnp"


def test_one_route_refusing_pins_the_other_as_jax():
    """g = 3 divides the positions but not the 128-row tile: the event
    route refuses, the dense one is pinned with a warning."""
    rng = np.random.default_rng(3)
    s = (rng.random((384, 256)) < 0.2).astype(np.float32)
    w = rng.standard_normal((256, 8)).astype(np.float32)
    occ = np.asarray(jops.padded_occupancy(jnp.asarray(s)))
    with pytest.warns(RuntimeWarning, match="hybrid event route"):
        with jd.use_hybrid():
            jattr = jd.resolve_attribution(
                "apec_matmul", jnp.asarray(s), jnp.asarray(w), g=3,
                occupancy=jnp.asarray(occ))
    with pytest.warns(RuntimeWarning, match="hybrid event route 'cuda'"):
        with td.use_hybrid():
            tbe, tattr = td.resolve_with_attribution(
                "apec_matmul", torch.from_numpy(s), torch.from_numpy(w),
                g=3, occupancy=torch.from_numpy(occ))
    assert tattr == _mapped(jattr) == f"cuda-pred<-{td.HYBRID}"
    out = tbe.fn(torch.from_numpy(s), torch.from_numpy(w), g=3,
                 occupancy=torch.from_numpy(occ))
    np.testing.assert_allclose(out.numpy(), s @ w, atol=1e-4)


def test_both_routes_refusing_run_the_normal_walk(monkeypatch):
    """Positions not divisible by g: both routes refuse and the normal
    walk runs as in repro on the CPU; on the card it raises before it
    lands on a plain route."""
    s = (np.random.default_rng(4).random((7, 256)) < 0.3).astype(np.float32)
    w = np.ones((256, 8), np.float32)
    occ = np.asarray(jops.padded_occupancy(jnp.asarray(s)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with jd.use_hybrid():
            jattr = jd.resolve_attribution(
                "apec_matmul", jnp.asarray(s), jnp.asarray(w), g=2,
                occupancy=jnp.asarray(occ))
        with td.use_hybrid():
            tattr = td.resolve_attribution(
                "apec_matmul", torch.from_numpy(s), torch.from_numpy(w), g=2,
                occupancy=torch.from_numpy(occ))
    assert tattr == jattr == f"{td.REF}<-jnp"
    monkeypatch.setattr(td, "_platform", lambda args: "cuda")
    with td.use_hybrid(), pytest.raises(ValueError, match="on the card"):
        td.resolve("apec_matmul", torch.from_numpy(s), torch.from_numpy(w),
                   g=2, occupancy=torch.from_numpy(occ))


def test_table_names_the_hybrid_pairs():
    text = td.table()
    for op in td.HYBRID_OPS:
        line = text.split(op, 1)[1].splitlines()[1]
        assert "hybrid: event=cuda | dense=cuda-pred" in line
        r, h = tcm.calibrated_route_params(op)
        assert f"calibrated r={r:.2f}, h={h:.2f}" in line


# -------------------------------------------------- helpers and harness
@pytest.mark.parametrize("shape,p", [((3, 130, 70), 0.3), ((256, 256), 0.05),
                                     ((4, 8, 40), 0.0)])
def test_spike_helpers_match_jax(shape, p):
    rng = np.random.default_rng(len(shape))
    x = (rng.random(shape) * (rng.random(shape) < p)).astype(np.float32)
    s = (x > 0).astype(np.float32)
    assert int(tspikes.event_count(torch.from_numpy(s))) == \
        int(jspikes.event_count(jnp.asarray(s)))
    np.testing.assert_allclose(float(tspikes.sparsity(torch.from_numpy(s))),
                               float(jspikes.sparsity(jnp.asarray(s))),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        tspikes.to_binary(torch.from_numpy(x - 0.1)).numpy(),
        np.asarray(jspikes.to_binary(jnp.asarray(x - 0.1))))
    m = shape[-2] - shape[-2] % 8
    k = shape[-1] - shape[-1] % 8
    t2 = torch.from_numpy(np.ascontiguousarray(s[..., :m, :k]))
    j2 = jnp.asarray(s[..., :m, :k])
    np.testing.assert_allclose(
        float(tspikes.occupancy_fraction(t2, 8, 8)),
        float(jspikes.occupancy_fraction(j2, 8, 8)), rtol=1e-6)


@pytest.mark.parametrize("cap", [None, 64])
def test_tile_csr_matches_jax(cap):
    s = _spikes(4, 4, 5)
    got = tspikes.tile_csr(torch.from_numpy(s), 128, 128, cap=cap)
    want = jspikes.tile_csr(jnp.asarray(s), 128, 128, cap=cap)
    for f in ("row_ptr", "tile_m_idx", "tile_k_idx", "occ", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.tiling == want.tiling and got.map_shape == want.map_shape


@pytest.mark.parametrize("op,names", [
    ("spike_matmul", ("cuda", "cuda-pred", "ref")),
    ("apec_matmul", ("cuda", "cuda-pred", "jnp", "ref")),
    ("econv", ("cuda", "cuda-pred", "ref"))])
def test_call_backend_matches_jax(op, names):
    rng = np.random.default_rng(11)
    if op == "econv":
        args = ((rng.random((2, 8, 8, 6)) < 0.3).astype(np.float32),
                rng.standard_normal((3, 3, 6, 10)).astype(np.float32))
        static = {"stride": 1, "padding": "SAME"}
    else:
        args = ((rng.random((32, 96)) < 0.3).astype(np.float32),
                rng.standard_normal((96, 20)).astype(np.float32))
        static = {"g": 2} if op == "apec_matmul" else {}
    want = np.asarray(jd.call_backend(op, "ref", *map(jnp.asarray, args),
                                      **static))
    for name in names:
        got = td.call_backend(op, name, *map(torch.from_numpy, args),
                              **static)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    if op == "apec_matmul":       # an unsupported pair errors, no fallback
        odd = (args[0][:31], args[1])
        for call, mod, cast in ((td.call_backend, td, torch.from_numpy),
                                (jd.call_backend, jd, jnp.asarray)):
            with pytest.raises(ValueError, match="unsupported"):
                call(op, "jnp", *map(cast, odd), g=2)
    assert td.resolve_name(op, *map(torch.from_numpy, args), **static) == \
        jd.resolve_name(op, *map(jnp.asarray, args), **static)


# --------------------------------------------------------------- models
@pytest.fixture
def card_routing(monkeypatch):
    """Automatic selection as on the card (`cuda-pipe` for the CSR-matmul
    ops), the kernel wrappers running their plain versions on CPU
    tensors."""
    monkeypatch.setattr(td, "_platform", lambda args: "cuda")


def _sf_case():
    jp = jsf.spikingformer_init(jax.random.PRNGKey(0), 1, 32)
    x = np.random.default_rng(1).random((2, 32, 32, 3), dtype=np.float32)
    jlogits, jstats = jsf.spikingformer_apply(
        jp, jnp.asarray(x), n_heads=4,
        spiking_cfg=JSpikingConfig(t_steps=2, lif_vth=1.0),
        collect_stats=True)
    params = tsf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")
    return params, torch.from_numpy(x), np.asarray(jlogits), \
        [np.asarray(s) for s in jstats]


def _vgg_case():
    jcfg = dataclasses.replace(
        jregistry.paper_cnn_configs()["vgg11"], img=32,
        spiking=JSpikingConfig(t_steps=2, lif_vth=0.5))
    tcfg = dataclasses.replace(
        paper_cnn_configs()["vgg11"], img=32,
        spiking=SpikingConfig(t_steps=2, lif_vth=0.5))
    jp = jcnn.vgg11_init(jcfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(4).random((2, 32, 32, 3), dtype=np.float32)
    jlogits, jstats = jcnn.vgg11_apply(jcfg, jp, jnp.asarray(x),
                                       collect_stats=True)
    return tcfg, params_from_numpy(jp, device="cpu"), torch.from_numpy(x), \
        np.asarray(jlogits), [np.asarray(s) for s in jstats]


def _check_model(run, jlogits, jstats):
    """Hybrid forward == automatic forward bit for bit (logits and every
    spike map); both against repro's within the model tests' tolerance."""
    with torch.inference_mode(), td.watch_resolutions() as rec:
        hyb_logits, hyb_stats = run(True)
    with torch.inference_mode():
        auto_logits, auto_stats = run(False)
    routed = [r["attribution"] for r in rec if td.HYBRID in r["attribution"]]
    assert torch.equal(hyb_logits, auto_logits)
    assert len(hyb_stats) == len(auto_stats) == len(jstats)
    for got, auto, want in zip(hyb_stats, auto_stats, jstats):
        assert torch.equal(got, auto)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(hyb_logits.numpy(), jlogits, atol=ATOL,
                               rtol=ATOL)
    return routed


@pytest.mark.parametrize("path", ["host", "device"])
def test_spikingformer_hybrid_equals_automatic_and_jax(card_routing,
                                                       calibration,
                                                       monkeypatch, path):
    if path == "device":
        monkeypatch.setattr(td, "_device_routed", lambda occ: True)
    params, x, jlogits, jstats = _sf_case()

    def run(hybrid):
        cfg = SpikingConfig(t_steps=2, lif_vth=1.0, hybrid=hybrid)
        return tsf.spikingformer_apply(params, x, n_heads=4, spiking_cfg=cfg,
                                       collect_stats=True)
    routed = _check_model(run, jlogits, jstats)
    mark = f"{td.HYBRID}[cuda|cuda-pred@b" if path == "device" \
        else f"<-{td.HYBRID}[b"
    assert any(mark in a for a in routed), routed


@pytest.mark.parametrize("path", ["host", "device"])
def test_vgg11_hybrid_equals_automatic_and_jax(card_routing, calibration,
                                               monkeypatch, path):
    if path == "device":
        monkeypatch.setattr(td, "_device_routed", lambda occ: True)
    tcfg, params, x, jlogits, jstats = _vgg_case()

    def run(hybrid):
        cfg = dataclasses.replace(tcfg, spiking=dataclasses.replace(
            tcfg.spiking, hybrid=hybrid))
        return tcnn.vgg11_apply(cfg, params, x, collect_stats=True)
    routed = _check_model(run, jlogits, jstats)
    mark = f"{td.HYBRID}[cuda|cuda-pred@b" if path == "device" \
        else f"<-{td.HYBRID}[b"
    assert any(mark in a for a in routed), routed
