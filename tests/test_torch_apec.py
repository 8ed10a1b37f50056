"""APEC in repro_torch against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through `repro`'s APEC
(its core module, its Pallas kernels in interpret mode, its registry) and
the port's. Overlap and residual words, occupancy maps, union work lists
and per-step counts must match exactly; float outputs within 1e-5, and
gradients within 1e-5 of `jax.grad` of the JAX `ref`. On CPU tensors the
port's kernel wrappers run their plain versions; the CUDA kernels are held
against those in `test_torch_cuda.py`.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apec as japec
from repro.core import events as jev
from repro.core import spikes as jsp
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.apec_kernel import apec_decompose_packed as \
    japec_decompose_packed
from repro_torch.core import apec as tapec
from repro_torch.core import events as tev
from repro_torch.core.spikes import (build_csr, pack_spikes_padded,
                                     watch_occupancy_prepasses)
from repro_torch.kernels import apec_kernel, dispatch, launch_counts, ops, \
    reset_launch_counts, spike_matmul

torch.set_num_threads(1)
ATOL = 1e-5


def _binary(rng, shape, p):
    return (rng.random(shape) < p).astype(np.float32)


def _clustered(rng, m, k, tile_p=0.6, p=0.4, tile=128):
    tiles = rng.random((-(-m // tile), -(-k // tile))) < tile_p
    mask = np.kron(tiles, np.ones((tile, tile)))[:m, :k]
    return (_binary(rng, (m, k), p) * mask).astype(np.float32)


def _eq(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------- core.apec
@pytest.mark.parametrize("g", [2, 4, 8])
def test_core_decompose_and_reconstruct_match_jax(g):
    s = _binary(np.random.default_rng(g), (3, 16, 40), 0.5)
    jov, jres = japec.apec_decompose(jnp.asarray(s), g)
    tov, tres = tapec.apec_decompose(_t(s), g)
    _eq(tov, jov)
    _eq(tres, jres)
    _eq(tapec.apec_reconstruct(tov, tres), japec.apec_reconstruct(jov, jres))
    _eq(tapec.apec_reconstruct(tov, tres), s)
    _eq(tapec.group_adjacent(_t(s), g, axis=-2),
        japec.group_adjacent(jnp.asarray(s), g, axis=-2))
    _eq(tapec.ungroup(tapec.group_adjacent(_t(s), g)), s)


@pytest.mark.parametrize("g", [2, 4])
def test_core_apec_matmul_jnp_matches_jax(g):
    rng = np.random.default_rng(10 + g)
    s = _binary(rng, (2, 24, 48), 0.4)
    w = rng.normal(size=(48, 20)).astype(np.float32)
    want = japec.apec_matmul_jnp(jnp.asarray(s), jnp.asarray(w), g)
    _close(tapec.apec_matmul_jnp(_t(s), _t(w), g), want)
    _close(tapec.apec_matmul_jnp(_t(s), _t(w), g), s @ w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("g", [2, 4, 8])
def test_core_apec_stats_match_jax(dtype, g):
    """Every field and Eq. 3's savings; a float64 input takes the float64
    sum (JAX, without x64, sees float32 and sums the same exact counts)."""
    s = _binary(np.random.default_rng(20 + g), (2, 32, 56), 0.45)
    want = japec.apec_stats(jnp.asarray(s.astype(np.float32)), g)
    got = tapec.apec_stats(_t(s.astype(dtype)), g)
    for field in ("events_before", "events_after", "eliminated",
                  "overlap_mean", "reduction_ratio", "groups_with_overlap"):
        _close(getattr(got, field), getattr(want, field))
    _close(got.accum_savings(16, 3), want.accum_savings(16, 3))
    if dtype == np.float64:
        assert got.events_after.dtype == torch.float64
        assert got.eliminated.dtype == torch.float64


def test_core_spatial_and_overhead_match_jax():
    s = _binary(np.random.default_rng(30), (2, 4, 8, 12), 0.5)
    for g in (2, 4):
        jov, jres = japec.apec_spatial(jnp.asarray(s), g)
        tov, tres = tapec.apec_spatial(_t(s), g)
        assert tuple(tov.shape) == jov.shape and \
            tuple(tres.shape) == jres.shape
        _eq(tov, jov)
        _eq(tres, jres)
    for co, k, w_acc in ((64, 3, 16), (128, 1, 8)):
        assert tapec.apec_overhead_bits(co, k, w_acc) == \
            japec.apec_overhead_bits(co, k, w_acc)
    assert tapec.apec_overhead_bits(64, 3) == japec.apec_overhead_bits(64, 3)


def test_core_indivisible_groups_raise_in_both():
    s = np.zeros((2, 10, 8), np.float32)
    for mod, x in ((japec, jnp.asarray(s)), (tapec, _t(s))):
        with pytest.raises(ValueError, match="not divisible"):
            mod.apec_decompose(x, 4)
    m = np.zeros((1, 2, 6, 4), np.float32)
    for mod, x in ((japec, jnp.asarray(m)), (tapec, _t(m))):
        with pytest.raises(ValueError, match="width 6"):
            mod.apec_spatial(x, 4)


# ------------------------------------------------------ kernel 19 (plain)
def _words(rng, p, dw):
    return rng.integers(0, 2 ** 32, size=(p, dw), dtype=np.uint64
                        ).astype(np.uint32)


@pytest.mark.parametrize("p,dw,g", [(16, 2, 2), (64, 4, 2), (32, 1, 4),
                                    (64, 8, 8), (48, 13, 2)])
def test_decompose_plain_matches_jax_kernel_and_ref(p, dw, g):
    """The shapes of the JAX kernel's own test plus a ragged dw (13 words,
    no 16-byte vector), sign bits included."""
    words = _words(np.random.default_rng(p + dw + g), p, dw)
    jov, jres = japec_decompose_packed(jnp.asarray(words), g,
                                       block_m=max(1, 8 // g),
                                       block_n=min(128, dw), interpret=True)
    rov, rres = jref.apec_decompose_packed_ref(jnp.asarray(words), g)
    tw = _t(words.view(np.int32)).view(torch.uint32)
    tov, tres = apec_kernel.apec_decompose_packed(tw, g)
    assert tov.dtype == tres.dtype == torch.uint32
    for port, a, b in ((tov, jov, rov), (tres, jres, rres)):
        got = port.view(torch.int32).numpy().view(np.uint32)
        _eq(got, a)
        _eq(got, b)


def test_decompose_packed_rejects_indivisible_rows():
    with pytest.raises(ValueError, match="not divisible"):
        apec_kernel.apec_decompose_packed(
            torch.zeros(10, 3, dtype=torch.int32).view(torch.uint32), 4)


@pytest.mark.parametrize("c", [32, 64, 70])
@pytest.mark.parametrize("g", [2, 4])
def test_ops_decompose_matches_jax(c, g):
    s = _binary(np.random.default_rng(40 + c + g), (32, c), 0.4)
    jov, jres = jops.apec_decompose(jnp.asarray(s), g)
    tov, tres = ops.apec_decompose(_t(s), g)
    _eq(tov, jov)
    _eq(tres, jres)


# ---------------------------------------------------- kernel 17 and ops
def _capture_jax_core(monkeypatch):
    rec = {}
    orig = jops._apec_matmul_csr_core

    def cap(res2, ov2, w2, csr, occ_res, occ_ov, **kw):
        rec.update(csr=csr, occ_res=occ_res, occ_ov=occ_ov)
        return orig(res2, ov2, w2, csr, occ_res, occ_ov, **kw)
    monkeypatch.setattr(jops, "_apec_matmul_csr_core", cap)
    return rec


def _capture_port_kernel(monkeypatch):
    rec = {}
    orig = spike_matmul.apec_matmul_csr

    def cap(res, ov, w, g, csr, occ_res, occ_ov):
        rec.update(csr=csr, occ_res=occ_res, occ_ov=occ_ov)
        return orig(res, ov, w, g, csr, occ_res, occ_ov)
    monkeypatch.setattr(spike_matmul, "apec_matmul_csr", cap)
    return rec


def _apec_case(seed, m=260, k=200, n=40):
    rng = np.random.default_rng(seed)
    s = _clustered(rng, m, k)
    s[128:256] = 0                                # an all-empty m-tile row
    w = rng.normal(size=(k, n)).astype(np.float32)
    return s, w


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("carried", [False, True])
def test_apec_matmul_csr_matches_jax_worklist_and_output(g, carried,
                                                         monkeypatch):
    """The union work list, both per-step count vectors and the output."""
    s, w = _apec_case(50 + g)
    occ = ops.padded_occupancy(_t(s)) if carried else None
    jrec = _capture_jax_core(monkeypatch)
    trec = _capture_port_kernel(monkeypatch)
    want = jops.apec_matmul_csr(
        jnp.asarray(s), jnp.asarray(w), g,
        occupancy=None if occ is None else jnp.asarray(occ.numpy()))
    with watch_occupancy_prepasses() as pre:
        got = ops.apec_matmul_csr(_t(s), _t(w), g, occupancy=occ)
    assert pre["calls"] == (0 if carried else 2)
    for field in ("row_ptr", "tile_m_idx", "tile_k_idx", "occ", "valid"):
        _eq(getattr(trec["csr"], field), getattr(jrec["csr"], field))
    _eq(trec["occ_res"], jrec["occ_res"])
    _eq(trec["occ_ov"], jrec["occ_ov"])
    assert trec["occ_res"].dtype == trec["occ_ov"].dtype == torch.int32
    _close(got, want)
    _close(got, s @ w)


@pytest.mark.parametrize("g", [2, 4])
def test_apec_matmul_csr_event_operand_matches_jax(g):
    """An EventTensor's carried map (and its cached work list) serves as
    the union gate: no dense pre-pass, the same output as JAX's."""
    s, w = _apec_case(60 + g, m=2 * 136, k=150, n=24)
    s3 = s.reshape(2, 136, 150)
    jet = jev.EventTensor.from_spikes(jnp.asarray(s3))
    tet = tev.EventTensor(_t(s3), _t(np.array(jet.occupancy)))
    want = jops.apec_matmul_csr(jet, jnp.asarray(w), g)
    with watch_occupancy_prepasses() as pre:
        got = ops.apec_matmul_csr(tet, _t(w), g)
    assert pre["calls"] == 0 and tuple(got.shape) == (2, 136, 24)
    _close(got, want)


def test_apec_csr_plain_gates_each_operand_on_its_own_counts():
    """A union step whose residual count is 0 adds only the overlap dot,
    and the reverse; a padding step past row_ptr[MT] adds nothing."""
    s = torch.ones(256, 128)
    w = torch.ones(128, 4)
    ov, res = ops.apec_decompose(s, 2)            # all overlap, no residual
    res = res + 1.0                               # a residual that is "live"
    csr = build_csr(torch.ones(2, 1, dtype=torch.int32), 128, 128)
    one, zero = torch.ones(2, dtype=torch.int32), \
        torch.zeros(2, dtype=torch.int32)
    only_ov = spike_matmul.apec_matmul_csr(res, ov, w, 2, csr, zero, one)
    only_res = spike_matmul.apec_matmul_csr(res, ov, w, 2, csr, one, zero)
    both = spike_matmul.apec_matmul_csr(res, ov, w, 2, csr, one, one)
    assert torch.all(only_ov == 128) and torch.all(only_res == 128)
    assert torch.all(both == 256)
    assert torch.equal(
        spike_matmul.csr_tile_gate(csr, 2, 1, zero),
        torch.zeros(2, 1, dtype=torch.bool))


def test_apec_csr_rejects_bad_groups_maps_and_counts():
    s, w = _t(np.ones((256, 64), np.float32)), torch.ones(64, 8)
    with pytest.raises(ValueError, match="not divisible"):
        ops.apec_matmul_csr(s[:255], w, 2)
    with pytest.raises(ValueError, match="block_m"):
        ops.apec_matmul_csr(s[:255], w, 3)
    with pytest.raises(ValueError, match="does not match"):
        ops.apec_matmul_csr(s, w, 2, occupancy=torch.ones(1, 1,
                                                          dtype=torch.int32))
    ov, res = ops.apec_decompose(s, 2)
    csr, occ_r, occ_o = ops.apec_union_worklist(res, ov, 2)
    with pytest.raises(ValueError, match="dividing 128"):
        spike_matmul.apec_matmul_csr(res, ov[:1], w, 256, csr, occ_r, occ_o)
    with pytest.raises(ValueError, match="per-step counts"):
        spike_matmul.apec_matmul_csr(res, ov, w, 2, csr, occ_r[:1], occ_o)
    # Every g dividing 128 runs on the fused kernel (as repro's
    # pallas-csr); a g that does not degrades along the declared chain to
    # the predicated route with a warning, as repro's degrades to pallas.
    js, jw = jnp.asarray(s.numpy()), jnp.asarray(w.numpy())
    dispatch.reset_fallback_warnings()
    jdispatch.reset_fallback_warnings()
    for g, want, jwant in (
            (16, "cuda", "pallas-csr-interpret"),
            (256, "cuda-pred<-cuda",
             "pallas-interpret<-pallas-csr-interpret")):
        with dispatch.use_backend("cuda", op="apec_matmul"), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _close(dispatch.apec_matmul(s, w, g=g), s.numpy() @ w.numpy())
            assert dispatch.resolve_attribution("apec_matmul", s, w,
                                                g=g) == want
        assert bool(caught) == (g == 256)
        with jdispatch.use_backend("pallas-csr-interpret", op="apec_matmul"), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert jdispatch.resolve_attribution("apec_matmul", js, jw,
                                                 g=g) == jwant


def test_apec_fused_kernels_take_g1_as_the_reference():
    """At g = 1 (APEC groups nothing: every spike is overlap) the fused
    routes, f32 and packed, accept the call as `repro`'s
    `_apec_csr_supports` does, and the fused plain versions on the union
    work list give `apec_matmul_csr_pallas(..., g=1, interpret=True)`'s
    values on the same numpy inputs."""
    from repro.kernels.spike_matmul import apec_matmul_csr_pallas
    s, w = _apec_case(71, m=256, k=256, n=128)
    ts, tw = _t(s), _t(w)
    js, jw = jnp.asarray(s), jnp.asarray(w)
    assert jdispatch._apec_csr_supports(js, jw, g=1) is None
    words = pack_spikes_padded(ts)
    for name, args, kw in (("cuda", (ts, tw), {"g": 1}),
                           ("cuda-packed", (words, tw),
                            {"g": 1, "packed_k": 256})):
        assert dispatch.get_backend("apec_matmul", name) \
            .unsupported_reason(*args, **kw) is None
    jov, jres = jops.apec_decompose(js, 1)
    occ_r = jsp.tile_occupancy(jres, 128, 128)
    occ_o = jsp.tile_occupancy(jov, 128, 128)
    jcsr = jsp.occupancy_to_csr(occ_r + occ_o, tiling=(128, 128))
    steps = (jcsr.tile_m_idx, jcsr.tile_k_idx)
    want = apec_matmul_csr_pallas(
        jres, jov, jw, 1, jcsr,
        (occ_r[steps] * jcsr.valid).astype(jnp.int32),
        (occ_o[steps] * jcsr.valid).astype(jnp.int32), interpret=True)
    ov, res = ops.apec_decompose(ts, 1)
    csr, cr, co = ops.apec_union_worklist(res, ov, 1)
    _close(spike_matmul.apec_matmul_csr(res, ov, tw, 1, csr, cr, co), want)
    ov_p, res_p = apec_kernel.apec_decompose_packed(words, 1)
    csr_p, cr_p, co_p = ops.apec_union_worklist(res_p, ov_p, 1, packed=True)
    _close(spike_matmul.apec_matmul_packed_csr(res_p, ov_p, tw, 1, csr_p,
                                               cr_p, co_p), want)
    _close(want, s @ w)


@pytest.mark.parametrize("rows,g", [(512, 2), (1024, 4), (260, 2)])
def test_group_occupancy_matches_jax(rows, g):
    s = _clustered(np.random.default_rng(rows + g), rows, 200)
    occ = ops.padded_occupancy(_t(s))
    want = jops._group_occupancy(jnp.asarray(occ.numpy()), g, rows)
    got = ops._group_occupancy(occ, g, rows)
    if want is None:
        assert got is None
    else:
        _eq(got, want)
        assert got.dtype == torch.int32
    assert ops._group_occupancy(None, g, rows) is None


@pytest.mark.parametrize("rows,g", [(512, 2), (260, 4)])
@pytest.mark.parametrize("carried", [False, True])
def test_apec_matmul_pred_matches_jax(rows, g, carried):
    rng = np.random.default_rng(70 + rows + g)
    s = _clustered(rng, rows, 160)
    w = rng.normal(size=(160, 30)).astype(np.float32)
    occ = ops.padded_occupancy(_t(s)) if carried else None
    want = jops.apec_matmul(
        jnp.asarray(s), jnp.asarray(w), g,
        occupancy=None if occ is None else jnp.asarray(occ.numpy()))
    _close(ops.apec_matmul(_t(s), _t(w), g, occupancy=occ), want)
    ov, res = ops.apec_decompose(_t(s), g)
    jov, jres = jops.apec_decompose(jnp.asarray(s), g)
    _close(ops.apec_matmul(_t(s), _t(w), g, decomposed=(res, ov)),
           jops.apec_matmul(jnp.asarray(s), jnp.asarray(w), g,
                            decomposed=(jres, jov)))


# --------------------------------------------------------------- registry
BACKENDS = ("ref", "jnp", "cuda-pred", "cuda")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("g", [2, 4])
def test_every_apec_backend_matches_jax_ref_values_and_grads(backend, g):
    rng = np.random.default_rng(80 + g)
    s = _binary(rng, (2, 136, 72), 0.5)
    w = rng.normal(size=(72, 40)).astype(np.float32)
    cot = rng.normal(size=(2, 136, 40)).astype(np.float32)

    def jloss(s_, w_):
        with jdispatch.use_backend("ref", op="apec_matmul"):
            out = jdispatch.apec_matmul(s_, w_, g=g)
        return jnp.sum(out * jnp.asarray(cot)), out
    (_, jout), (jds, jdw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(s), jnp.asarray(w))
    ts = _t(s).requires_grad_(True)
    tw = _t(w).requires_grad_(True)
    with dispatch.use_backend(backend, op="apec_matmul"):
        assert dispatch.resolve("apec_matmul", ts, tw, g=g).name == backend
        out = dispatch.apec_matmul(ts, tw, g=g)
    ds, dw = torch.autograd.grad((out * _t(cot)).sum(), (ts, tw))
    _close(out.detach(), jout)
    _close(ds, jds)
    _close(dw, jdw)


def test_apec_resolution_follows_the_reference():
    """`jnp` above `ref` on the CPU (as in repro); the fused kernel route
    on CUDA tensors only, and the predicated route only by override."""
    s, w = torch.zeros(2, 16, 48), torch.zeros(48, 8)
    assert dispatch.resolve("apec_matmul", s, w, g=2).name == "jnp"
    assert jdispatch.resolve_name("apec_matmul", jnp.zeros((2, 16, 48)),
                                  jnp.zeros((48, 8)), g=2) == "jnp"
    cuda = dispatch.get_backend("apec_matmul", "cuda")
    assert cuda.platforms == ("cuda",) and cuda.priority == 20
    assert not dispatch.get_backend("apec_matmul", "cuda-pred").auto


def test_apec_entry_point_takes_event_tensors():
    rng = np.random.default_rng(90)
    # 256 rows: the predicated route folds the carried map into the
    # overlap's (rows % (128 * g) == 0), so no route re-derives a map.
    s = _clustered(rng, 2 * 128, 96).reshape(2, 128, 96)
    w = rng.normal(size=(96, 16)).astype(np.float32)
    et = tev.EventTensor(_t(s), ops.padded_occupancy(_t(s)))
    for backend in BACKENDS:
        with dispatch.use_backend(backend, op="apec_matmul"), \
                watch_occupancy_prepasses() as pre:
            out = tapec.apec_matmul(et, _t(w), 2)
        assert pre["calls"] == 0, backend
        _close(out, s @ w)


def test_apec_plain_versions_do_not_count_launches():
    s, w = _apec_case(95)
    reset_launch_counts()
    ops.apec_matmul_csr(_t(s), _t(w), 2)
    ops.apec_matmul(_t(s), _t(w), 2)
    assert set(launch_counts().values()) == {0}


# ---------------------------------------------------- the model's spikes
def test_spikingformer_ffn_input_through_apec_matches_jax(monkeypatch):
    """A depth-1 SpikingFormer's FFN inputs, captured from both packages'
    forwards on the same params and images: equal spikes and maps, and
    `apec_matmul` on them (g = 2, 4) within 1e-5 of JAX's."""
    from repro.configs.base import SpikingConfig as JSpikingConfig
    from repro.models import spikingformer as jsf
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.models import spikingformer as tsf
    jp = jsf.spikingformer_init(jax.random.PRNGKey(0), 1, 32)
    x = np.random.default_rng(1).random((2, 32, 32, 3), dtype=np.float32)
    jcap, tcap = [], []
    jorig, torig = jdispatch.spike_matmul, dispatch.spike_matmul

    def jrec(s, w):
        jcap.append((s, w))
        return jorig(s, w)

    def trec(s, w):
        tcap.append((s, w))
        return torig(s, w)
    monkeypatch.setattr(jdispatch, "spike_matmul", jrec)
    monkeypatch.setattr(dispatch, "spike_matmul", trec)
    jsf.spikingformer_apply(jp, jnp.asarray(x), n_heads=4,
                            spiking_cfg=JSpikingConfig(t_steps=2,
                                                       lif_vth=0.5))
    params = tsf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")
    with torch.inference_mode():
        tsf.spikingformer_apply(params, torch.from_numpy(x), n_heads=4,
                                spiking_cfg=SpikingConfig(t_steps=2,
                                                          lif_vth=0.5))
    assert len(jcap) == len(tcap) == 2
    for (js, jw), (ts, tw) in zip(jcap, tcap):
        _eq(ts.spikes, js.spikes)
        _eq(ts.occupancy, js.occupancy)
        for g in (2, 4):
            want = japec.apec_matmul(js, jw, g)
            with dispatch.use_backend("cuda", op="apec_matmul"):
                got = tapec.apec_matmul(ts, tw, g)
            _close(got, want)
            _close(tapec.apec_matmul(ts, tw, g), want)


# ------------------------------------------------- default weight device
@pytest.mark.parametrize("name", ["dense_init", "conv_init"])
def test_weight_inits_default_to_cuda(name):
    """`dense_init` and `_conv_init` take the package's CUDA default: with
    no card they raise instead of returning CPU tensors."""
    from repro_torch.models.cnn import _conv_init
    from repro_torch.models.layers import dense_init

    def make(**kw):
        g = torch.Generator().manual_seed(0)
        if name == "dense_init":
            return dense_init(8, 4, generator=g, **kw)
        return _conv_init(3, 2, 4, generator=g, **kw)
    assert make(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make().is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
