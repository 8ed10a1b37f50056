"""Packed spike payloads: repro_torch against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Words (compared as uint32), popcounts, tile maps and chunk maps must
match exactly; the packed matmuls within 1e-5 and the packed conv within
1e-4 (the reference's own tolerances in tests/test_packed_events.py);
whole packed forwards within 1e-4 of `repro`'s packed forward on the CPU.
The port's kernel routes run their plain versions here (CPU tensors);
the kernels themselves are held to those plain versions on a card in
tests/test_torch_cuda.py.
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
from repro.core import events as jev
from repro.core import spikes as jsp
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro.models import spikingformer as jsf
from repro_torch.configs.base import SpikingConfig
from repro_torch.configs.registry import paper_cnn_configs
from repro_torch.core import events as tev
from repro_torch.core import spikes as tsp
from repro_torch.kernels import (dispatch, launch_counts, lif_scan, ops,
                                 reset_launch_counts)
from repro_torch.models import cnn as tcnn
from repro_torch.models import spikingformer as tsf
from repro_torch.models.layers import params_from_numpy

torch.set_num_threads(1)
MATMUL_TOL = 1e-5
CONV_TOL = 1e-4
MODEL_TOL = 1e-4


def _binary(rng, shape, p=0.3):
    return (rng.random(shape) < p).astype(np.float32)


def _clustered(rng, m, k, tile_p=0.5, p=0.3, tile=128):
    """Binary (m, k) spikes with whole empty 128x128 tiles."""
    tiles = rng.random((-(-m // tile), -(-k // tile))) < tile_p
    mask = np.kron(tiles, np.ones((tile, tile)))[:m, :k]
    return (_binary(rng, (m, k), p) * mask).astype(np.float32)


def _words(t):
    """A port uint32 tensor as numpy uint32."""
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def _twords(a):
    """numpy uint32 words as a port uint32 tensor."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32)) \
        .view(torch.uint32)


def _jwords(a):
    return jnp.asarray(np.asarray(a, dtype=np.uint32))


@pytest.fixture
def card_routing(monkeypatch):
    """Automatic selection as on the card (the platform read as `cuda`):
    dense calls land on `cuda`, packed ones on `cuda-packed` (their
    `-pipe` routes for the CSR-matmul ops and APEC), and the kernel
    wrappers run their plain versions on the CPU tensors."""
    monkeypatch.setattr(dispatch, "_platform", lambda args: "cuda")


# --------------------------------------------------------- popcount, maps
def test_popcount_matches_jax_on_every_bit():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, size=(7, 33), dtype=np.uint64) \
        .astype(np.uint32)
    words[0, :4] = (0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF)
    got = tsp.popcount(_twords(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsp.popcount(_jwords(words))))


@pytest.mark.parametrize("m,k,tm,tk", [(256, 256, 128, 128), (64, 96, 8, 32),
                                       (128, 200, 128, 128)])
def test_packed_tile_occupancy_matches_jax_and_the_dense_map(m, k, tm, tk):
    """Pad bits (k=200 leaves 24 in the last word) never count; the word
    pre-pass ticks its own watcher, not the dense one."""
    rng = np.random.default_rng(1)
    s = _clustered(rng, m, k)
    jwords = jsp.pack_spikes_padded(jnp.asarray(s))
    words = tsp.pack_spikes_padded(torch.from_numpy(s))
    np.testing.assert_array_equal(_words(words), np.asarray(jwords))
    kw = words.shape[1]
    if kw % (tk // 32):
        pad = (-kw) % (tk // 32)
        words = torch.nn.functional.pad(words.view(torch.int32),
                                        (0, pad)).view(torch.uint32)
        jwords = jnp.pad(jwords, ((0, 0), (0, pad)))
    with tsp.watch_occupancy_prepasses() as dense, \
            tsp.watch_word_prepasses() as word:
        got = tsp.packed_tile_occupancy(words, tm, tk)
    assert dense["calls"] == 0 and word["calls"] == 1
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsp.packed_tile_occupancy(jwords, tm, tk)))
    dense_map = tsp.ragged_tile_occupancy(torch.from_numpy(s), tm, tk)
    np.testing.assert_array_equal(
        tsp.ragged_packed_tile_occupancy(tsp.pack_spikes_padded(
            torch.from_numpy(s)), tm, tk).numpy(), dense_map.numpy())


def test_packed_tile_occupancy_rejects_a_wrong_width():
    words = tsp.pack_spikes_padded(torch.ones(128, 64))
    for pkg, w in ((tsp, words), (jsp, jsp.pack_spikes_padded(
            jnp.ones((128, 64))))):
        with pytest.raises(ValueError, match="does not cover"):
            pkg.packed_tile_occupancy(w, 128, 128, k=96)
    with pytest.raises(ValueError, match="not tileable"):
        tsp.packed_tile_occupancy(words, 128, 128)


# ------------------------------------------------------------ EventTensor
@pytest.mark.parametrize("shape", [(2, 4, 8, 48), (3, 40, 96)])
def test_event_tensor_from_spikes_packed_matches_jax(shape):
    rng = np.random.default_rng(2)
    s = _binary(rng, shape)
    jet = jev.EventTensor.from_spikes(jnp.asarray(s), pack=True)
    tet = tev.EventTensor.from_spikes(torch.from_numpy(s), pack=True)
    assert tet.is_packed and tet.spikes is None and jet.is_packed
    assert tet.shape == tuple(jet.shape) and tet.packed.dtype == torch.uint32
    np.testing.assert_array_equal(_words(tet.packed), np.asarray(jet.packed))
    for a, b in ((tet.occupancy, jet.occupancy), (tet.chunks, jet.chunks)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tet.dense().numpy(), s)
    assert tet.astype(torch.float64).dense().dtype == torch.float64


def test_event_tensor_packed_reshape_keeps_words_and_guards_trailing_axis():
    rng = np.random.default_rng(3)
    s = _binary(rng, (2, 16, 64))
    et = tev.EventTensor.from_spikes(torch.from_numpy(s), pack=True)
    folded = et.reshape(-1, 64)
    assert folded.is_packed and folded.shape == (32, 64)
    assert folded.occupancy is et.occupancy
    np.testing.assert_array_equal(folded.dense().numpy(), s.reshape(-1, 64))
    with pytest.raises(ValueError, match="explicit unpack"):
        et.reshape(2, 16 * 64)
    with pytest.raises(ValueError, match="does not cover"):
        tev.EventTensor(None, None, packed=folded.packed, feature_size=96)
    with pytest.raises(ValueError, match="feature_size"):
        tev.EventTensor(None, None, packed=folded.packed)


@pytest.mark.parametrize("c", [48, 64])
def test_max_pool_on_words_matches_jax(c):
    rng = np.random.default_rng(4)
    s = _binary(rng, (2, 8, 6, c), p=0.2)
    jet = jev.EventTensor.from_spikes(jnp.asarray(s), pack=True)
    tet = tev.EventTensor.from_spikes(torch.from_numpy(s), pack=True)
    jp = jev.max_pool_events(jet, 2)
    with tsp.watch_occupancy_prepasses() as pre:
        tp = tev.max_pool_events(tet, 2)
    assert pre["calls"] == 0 and tp.is_packed and tp.shape == (2, 4, 3, c)
    np.testing.assert_array_equal(_words(tp.packed), np.asarray(jp.packed))
    for a, b in ((tp.occupancy, jp.occupancy), (tp.chunks, jp.chunks)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tp.dense().numpy(),
        tev.max_pool_events(torch.from_numpy(s), 2).numpy())


# --------------------------------------------------- row 6: packed fire
@pytest.mark.parametrize("k", [48, 96, 200])
def test_packed_fire_matches_jax_kernel(k):
    """Kernel 6's plain version and `ops.lif_occ(packed=True)` against
    `lif_scan_occ_packed_pallas` (interpret mode): words, tile map and
    chunk map."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 2, 16, k)) * 1.2 + 0.3).astype(np.float32)
    jw, jocc, jchunks = jops.lif_occ(jnp.asarray(x), v_th=0.5, packed=True)
    tw, tocc, tchunks = ops.lif_occ(torch.from_numpy(x), v_th=0.5,
                                    packed=True)
    assert tw.shape == (2, 2, 16, tsp.packed_width(k))
    np.testing.assert_array_equal(_words(tw), np.asarray(jw))
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(tchunks.numpy(), np.asarray(jchunks))
    pw, pcnt = lif_scan.lif_counts_packed_plain(
        torch.from_numpy(x.reshape(2, 32, k)), v_th=0.5)
    s, cnt = lif_scan.lif_counts_plain(torch.from_numpy(x.reshape(2, 32, k)),
                                       v_th=0.5)
    assert torch.equal(pcnt, cnt)
    np.testing.assert_array_equal(_words(pw), _words(
        tsp.pack_spikes_padded(s)))
    # the ref route of the registry gives the same words and maps
    rw, rocc, rchunks = dispatch.get_backend("lif_scan_occ", "ref").fn(
        torch.from_numpy(x), v_th=0.5, packed=True)
    np.testing.assert_array_equal(_words(rw), np.asarray(jw))
    assert torch.equal(rocc, tocc) and torch.equal(rchunks, tchunks)


# --------------------------------------------- rows 13 and 15: matmuls
@pytest.mark.parametrize("m,k,n,carried", [(256, 256, 128, False),
                                           (200, 96, 40, True),
                                           (130, 384, 70, False)])
def test_spike_matmul_packed_matches_jax(m, k, n, carried):
    rng = np.random.default_rng(6)
    s = _clustered(rng, m, k)
    w = rng.normal(size=(k, n)).astype(np.float32)
    words = np.asarray(jsp.pack_spikes_padded(jnp.asarray(s)))
    occ = np.array(jops.padded_occupancy(jnp.asarray(s))) if carried \
        else None
    want = jops.spike_matmul_packed(
        _jwords(words), jnp.asarray(w), packed_k=k,
        occupancy=None if occ is None else jnp.asarray(occ))
    with tsp.watch_word_prepasses() as pre:
        got = ops.spike_matmul_packed(
            _twords(words), torch.from_numpy(w), packed_k=k,
            occupancy=None if occ is None else torch.from_numpy(occ))
    assert pre["calls"] == (0 if carried else 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MATMUL_TOL, rtol=MATMUL_TOL)
    np.testing.assert_allclose(got.numpy(), s @ w, atol=MATMUL_TOL,
                               rtol=MATMUL_TOL)


@pytest.mark.parametrize("ci", [8, 32, 48])
@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID"), (2, "VALID")])
def test_econv_packed_matches_jax(ci, stride, padding):
    rng = np.random.default_rng(7)
    s = _binary(rng, (2, 9, 8, ci), p=0.25)
    w = (rng.normal(size=(3, 3, ci, 6)) / ci ** 0.5).astype(np.float32)
    want = jops.econv_packed(jnp.asarray(s), jnp.asarray(w), stride=stride,
                             padding=padding)
    got = ops.econv_packed(tev.EventTensor.from_spikes(torch.from_numpy(s),
                                                       pack=True),
                           torch.from_numpy(w), stride=stride,
                           padding=padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CONV_TOL,
                               rtol=CONV_TOL)


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("carried", [False, True])
def test_apec_matmul_packed_matches_jax(g, carried):
    rng = np.random.default_rng(8)
    m, k, n = 256, 200, 60
    s = _clustered(rng, m, k, p=0.4)
    s[1::2] = np.maximum(s[1::2], s[0::2] * (rng.random((m // 2, k)) < 0.7))
    w = rng.normal(size=(k, n)).astype(np.float32)
    words = np.asarray(jsp.pack_spikes_padded(jnp.asarray(s)))
    occ = np.array(jops.padded_occupancy(jnp.asarray(s))) if carried \
        else None
    want = jops.apec_matmul_packed(
        _jwords(words), jnp.asarray(w), g, packed_k=k,
        occupancy=None if occ is None else jnp.asarray(occ))
    with tsp.watch_word_prepasses() as pre, \
            tsp.watch_occupancy_prepasses() as dense:
        got = ops.apec_matmul_packed(
            _twords(words), torch.from_numpy(w), g, packed_k=k,
            occupancy=None if occ is None else torch.from_numpy(occ))
    assert dense["calls"] == 0 and pre["calls"] == (0 if carried else 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MATMUL_TOL, rtol=MATMUL_TOL)


# ---------------------------------------------------------------- routing
def test_dense_calls_never_resolve_to_a_packed_backend(card_routing,
                                                      monkeypatch):
    """With the platform read as `cuda` (no card here), dense calls land
    on `cuda` (`cuda-pipe` for the CSR-matmul ops and APEC) and packed
    calls on `cuda-packed` (`cuda-packed-pipe`); a packed call with no
    packed backend on the card raises instead of unpacking."""
    dense = dispatch.resolved_backends("cpu")
    packed = dispatch.resolved_backends("cpu", packed=True)
    piped = ("spike_matmul", "econv", "apec_matmul")
    for op in dispatch.PACKED_OPS:
        assert dense[op] == (dispatch.CUDA_PIPE if op in piped
                             else dispatch.CUDA), op
        assert packed[op] == (dispatch.CUDA_PACKED_PIPE if op in piped
                              else dispatch.CUDA_PACKED), op
        for name in (dispatch.CUDA_PACKED, dispatch.CUDA_PACKED_PIPE):
            if name in dispatch.backend_names(op):
                be = dispatch.get_backend(op, name)
                assert be.payload == ("packed",) and \
                    be.platforms == ("cuda",)
    assert {op: b for op, b in packed.items()
            if op not in dispatch.PACKED_OPS} == \
        {op: b for op, b in dense.items() if op not in dispatch.PACKED_OPS}
    for name in (dispatch.CUDA_PACKED, dispatch.CUDA_PACKED_PIPE):
        be = dispatch.get_backend("spike_matmul", name)
        monkeypatch.setitem(dispatch._REGISTRY["spike_matmul"].backends,
                            name, dataclasses.replace(be, auto=False))
    args, kwargs = dispatch._packed_example("spike_matmul",
                                            torch.device("cpu"))
    with pytest.raises(RuntimeError, match="packed-payload backend"):
        dispatch.resolve("spike_matmul", *args, **kwargs)


def test_packed_call_pinned_to_a_dense_backend_takes_the_unpack_shim():
    rng = np.random.default_rng(9)
    s = _clustered(rng, 256, 96)
    w = torch.from_numpy(rng.normal(size=(96, 24)).astype(np.float32))
    et = tev.EventTensor.from_spikes(torch.from_numpy(s), pack=True)
    for name in (dispatch.CUDA, dispatch.REF):
        with dispatch.use_backend(name, op="spike_matmul"):
            dispatch._WARNED.clear()
            with pytest.warns(RuntimeWarning, match="unpack"):
                got = dispatch.spike_matmul(et, w)
            args, kw = dispatch._event_args(et)
            assert dispatch.resolve("spike_matmul", args, w, **kw).name == \
                f"{name}+unpack"
        np.testing.assert_allclose(got.numpy(), s @ w.numpy(),
                                   atol=MATMUL_TOL, rtol=MATMUL_TOL)
    # the CPU's default lands on ref, through the same shim
    args, kw = dispatch._event_args(et)
    assert dispatch.resolve("spike_matmul", args, w, **kw).name == \
        "ref+unpack"


def test_packed_calls_on_cpu_tensors_walk_the_plain_versions():
    """`cuda-packed` on CPU tensors: the kernels' plain versions, no
    launch, the values of `ref`; the weights' gradient flows through the
    unpacked words."""
    rng = np.random.default_rng(10)
    s = _clustered(rng, 256, 64)
    et = tev.EventTensor.from_spikes(torch.from_numpy(s), pack=True)
    w = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    wc = torch.from_numpy(rng.normal(size=(3, 3, 64, 8)).astype(np.float32))
    spatial = et.reshape(4, 8, 8, 64)
    reset_launch_counts()
    with dispatch.use_backend(dispatch.CUDA_PACKED):
        wg = w.clone().requires_grad_(True)
        out = dispatch.spike_matmul(et, wg)
        (dw,) = torch.autograd.grad((out * out).sum(), wg)
        apec = dispatch.apec_matmul(et, w, g=2)
        wcg = wc.clone().requires_grad_(True)
        conv = dispatch.econv(spatial, wcg)
        (dwc,) = torch.autograd.grad(conv.sum(), wcg)
    assert set(launch_counts().values()) == {0}
    st = torch.from_numpy(s)
    wr = w.clone().requires_grad_(True)
    ref = st @ wr
    (dw_ref,) = torch.autograd.grad((ref * ref).sum(), wr)
    wcr = wc.clone().requires_grad_(True)
    conv_ref = dispatch.get_backend("econv", dispatch.REF).fn(
        st.reshape(4, 8, 8, 64), wcr)
    (dwc_ref,) = torch.autograd.grad(conv_ref.sum(), wcr)
    for a, b, tol in ((out, ref, MATMUL_TOL), (apec, st @ w, MATMUL_TOL),
                      (dw, dw_ref, MATMUL_TOL), (conv, conv_ref, CONV_TOL),
                      (dwc, dwc_ref, CONV_TOL)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=tol, rtol=tol)


# ------------------------------------------------------ whole forwards
def _record_fires(monkeypatch, module):
    fires = []
    orig = module.lif_fire_events

    def rec(*a, **kw):
        et = orig(*a, **kw)
        fires.append(et)
        return et
    monkeypatch.setattr(module, "lif_fire_events", rec)
    return fires


def _jax_quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.asarray(fn())


def test_packed_spikingformer_matches_jax(card_routing, monkeypatch):
    """Depth 1, dim 64 (SPS widths 8, 16, 32, 64: two econvs without a
    carried map, one with), T=2, B=2, on the port's kernel route against
    `repro`'s packed forward (ref + unpack shim on the CPU)."""
    depth, dim, heads, t = 1, 64, 4, 2
    jp = jsf.spikingformer_init(jax.random.PRNGKey(0), depth, dim)
    x = np.random.default_rng(11).random((2, 32, 32, 3), dtype=np.float32)
    want = _jax_quiet(lambda: jsf.spikingformer_apply(
        jp, jnp.asarray(x), n_heads=heads,
        spiking_cfg=JSpikingConfig(t_steps=t, lif_vth=0.5, packed=True)))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    fires = _record_fires(monkeypatch, tsf)
    cfg = SpikingConfig(t_steps=t, lif_vth=0.5, packed=True)
    with torch.inference_mode(), tsp.watch_occupancy_prepasses() as dense, \
            tsp.watch_word_prepasses() as word:
        got = tsf.spikingformer_apply(params, torch.from_numpy(x),
                                      n_heads=heads, spiking_cfg=cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    assert len(fires) == 4 + 2 * depth
    assert all(f.spikes is None and f.packed.dtype == torch.uint32
               for f in fires)
    assert dense["calls"] == 0 and word["calls"] == 2


def test_packed_segnet_matches_jax(card_routing, monkeypatch):
    """SegNet at 16x16 (ci = 8 and 16 into the event convs, two transposed
    convs that unpack) on the port's kernel route against `repro`'s
    packed forward."""
    jcfg = jpaper_cnn_configs()["segnet"]
    jcfg = dataclasses.replace(jcfg, img=16, spiking=JSpikingConfig(
        t_steps=2, lif_vth=0.5, packed=True))
    jp = jcnn.segnet_init(jcfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(12).random((2, 16, 16, 3), dtype=np.float32)
    want = _jax_quiet(lambda: jcnn.segnet_apply(jcfg, jp, jnp.asarray(x)))
    cfg = dataclasses.replace(paper_cnn_configs()["segnet"], img=16,
                              spiking=SpikingConfig(t_steps=2, lif_vth=0.5,
                                                    packed=True))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    fires = _record_fires(monkeypatch, tcnn)
    routes = set()
    resolve = dispatch.resolve

    def rec(op, *a, **kw):
        be = resolve(op, *a, **kw)
        routes.add((op, be.name))
        return be
    monkeypatch.setattr(dispatch, "resolve", rec)
    with torch.inference_mode():
        got = tcnn.segnet_apply(cfg, params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    assert len(fires) == 5
    assert all(f.spikes is None for f in fires)
    assert routes == {("econv", "cuda-pipe"), ("econv", "cuda-packed-pipe"),
                      ("tconv", "cuda"), ("lif_scan_occ", "cuda")}
