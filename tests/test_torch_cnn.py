"""The CNN family (VGG11, ResNet18, SegNet) and its ops against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
params go across through `params_from_numpy`. The port runs on its `ref`
oracles and on its kernel path (`use_backend("cuda")`: the kernel
wrappers' plain versions on CPU tensors, which walk the carried maps, the
CSR work lists and the predicated tile gates). Tolerances: logits, conv
and matmul outputs and gradients within 1e-5 (fp32 summation order);
spike maps, quantized codes, pads and zero-insertion exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import SpikingConfig as JSpikingConfig
from repro.core import direct_coding as jdc
from repro.core import eafc as jeafc
from repro.core import events as jev
from repro.core import econv as jeconv
from repro.data.synthetic import seg_batch as jseg_batch
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels.spike_matmul import spike_matmul_pallas
from repro.models import cnn as jcnn
from repro_torch.configs.base import SpikingConfig
from repro_torch.configs.registry import paper_cnn_configs
from repro_torch.core import direct_coding as tdc
from repro_torch.core import eafc as teafc
from repro_torch.core import econv as teconv
from repro_torch.core.events import EventTensor
from repro_torch.core.spikes import watch_occupancy_prepasses
from repro_torch.data.synthetic import seg_batch
from repro_torch.kernels import dispatch, ops, spike_matmul
from repro_torch.models import cnn as tcnn
from repro_torch.models.layers import params_from_numpy, params_to_numpy

torch.set_num_threads(1)
ATOL = 1e-5
CASES = [  # (model, img, t_steps, v_th)
    ("vgg11", 32, 4, 0.5),
    ("resnet18", 32, 2, 0.5),
    ("segnet", 16, 2, 0.5),
    ("segnet", 32, 4, 0.5),
]
# Dense occupancy pre-passes per forward on the kernel path: the coded
# input of the first conv, and each transposed conv's patch matrix (no map
# survives zero-insertion).
PREPASSES = {"vgg11": 1, "resnet18": 1, "segnet": 3}


def _binary(rng, shape, p):
    return (rng.random(shape) < p).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=ATOL, err_msg=what)


def _configs(name, img, t, v_th):
    jcfg = dataclasses.replace(jregistry.paper_cnn_configs()[name], img=img,
                               spiking=JSpikingConfig(t_steps=t,
                                                      lif_vth=v_th))
    tcfg = dataclasses.replace(paper_cnn_configs()[name], img=img,
                               spiking=SpikingConfig(t_steps=t, lif_vth=v_th))
    return jcfg, tcfg


def _min_margin(drives, v_th, decay=0.5):
    """Smallest |v - v_th| over every fire stage's membrane trace."""
    best = np.inf
    for x in drives:
        v = torch.zeros_like(x[0])
        for t in range(x.shape[0]):
            v = decay * v + x[t]
            best = min(best, (v - v_th).abs().min().item())
            v = v - (v >= v_th).float() * v_th
    return best


# --------------------------------------------- params_from_numpy repair
def test_params_from_numpy_keeps_none_and_int_leaves():
    """VGG11's pooling slots stay None and ResNet18's block strides stay
    Python ints (they used to become tensor(nan) and tensor(2.))."""
    cfgs = jregistry.paper_cnn_configs()
    vgg = params_from_numpy(jcnn.vgg11_init(cfgs["vgg11"],
                                            jax.random.PRNGKey(0)),
                            device="cpu")
    assert [i for i, w in enumerate(vgg["convs"]) if w is None] == \
        [i for i, layer in enumerate(tcnn.VGG11_LAYERS)
         if layer.kind == "maxpool"]
    res = params_from_numpy(jcnn.resnet18_init(cfgs["resnet18"],
                                               jax.random.PRNGKey(0)),
                            device="cpu")
    strides = [blk["stride"] for blk in res["blocks"]]
    assert strides == [1, 1, 2, 1, 2, 1, 2, 1]
    assert all(type(s) is int for s in strides)
    back = params_to_numpy(res)
    assert back["blocks"][2]["stride"] == 2 and \
        params_to_numpy(vgg)["convs"][1] is None
    assert isinstance(back["stem"], np.ndarray)


def test_port_init_matches_jax_tree_and_configs():
    for name in ("vgg11", "resnet18", "segnet"):
        jcfg = jregistry.paper_cnn_configs()[name]
        tcfg = paper_cnn_configs()[name]
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jp = getattr(jcnn, f"{name}_init")(jcfg, jax.random.PRNGKey(0))
        tp = getattr(tcnn, f"{name}_init")(
            tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
        jleaves, jtree = jax.tree_util.tree_flatten(jp)
        tleaves, ttree = jax.tree_util.tree_flatten(tp)
        assert jtree == ttree, name
        assert [np.shape(a) for a in jleaves] == \
            [np.shape(a) for a in tleaves], name


# ------------------------------------------------------ whole models
@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "%s-img%d-T%d" % c[:3])
def case(request):
    name, img, t, v_th = request.param
    jcfg, tcfg = _configs(name, img, t, v_th)
    jp = getattr(jcnn, f"{name}_init")(jcfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(img + t).random((2, img, img, 3),
                                              dtype=np.float32)
    logits, stats = getattr(jcnn, f"{name}_apply")(jcfg, jp, jnp.asarray(x),
                                                   collect_stats=True)
    return dict(name=name, cfg=tcfg, v_th=v_th, x=torch.from_numpy(x),
                params=params_from_numpy(jp, device="cpu"),
                logits=np.asarray(logits),
                stats=[np.asarray(s) for s in stats])


def _run_port(case, monkeypatch=None):
    drives = []
    if monkeypatch is not None:          # record every fire stage's drive
        orig = dispatch.lif_scan_occ

        def rec(x, *a, **kw):
            drives.append(x.detach().clone())
            return orig(x, *a, **kw)
        monkeypatch.setattr(dispatch, "lif_scan_occ", rec)
    with torch.inference_mode():
        logits, stats = getattr(tcnn, f"{case['name']}_apply")(
            case["cfg"], case["params"], case["x"], collect_stats=True)
    return logits, stats, drives


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_cnn_logits_and_spike_maps_match_jax(case, backend, monkeypatch):
    with dispatch.use_backend(backend):
        logits, stats, drives = _run_port(case, monkeypatch)
    assert len(stats) == len(case["stats"])
    for i, (got, want) in enumerate(zip(stats, case["stats"])):
        n_diff = int((got.numpy() != want).sum())
        assert n_diff == 0, (
            f"layer {i}: {n_diff} spikes differ; smallest |v - v_th| "
            f"margin {_min_margin(drives, case['v_th'])}")
    assert any(s.any() for s in case["stats"][-2:])   # deep layers fire
    _close(logits.numpy(), case["logits"])


def test_cnn_kernel_path_prepasses(case):
    """The kernel path re-derives occupancy only where no map can exist:
    the direct-coded input and the transposed convs' patch matrices."""
    with dispatch.use_backend("cuda"), watch_occupancy_prepasses() as rec:
        _run_port(case)
    assert rec["calls"] == PREPASSES[case["name"]]


def test_unported_modes_raise_with_their_roadmap_item():
    """The mode this test held refused, `SpikingConfig(hybrid=True)`
    (ROADMAP queue 1 item 4), is ported: SegNet runs under it, routing
    the carried maps' econv calls, and its output equals the default
    forward's within ATOL (tests/test_torch_hybrid.py holds the models to
    the automatic forward bit for bit and to repro's)."""
    cfg = paper_cnn_configs()["segnet"]
    p = tcnn.segnet_init(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 16, 16, 3), dtype=np.float32))
    out = {}
    for hybrid in (True, False):
        spiking = SpikingConfig(t_steps=2, hybrid=hybrid)
        with torch.inference_mode(), dispatch.watch_resolutions() as rec:
            out[hybrid] = tcnn.segnet_apply(
                dataclasses.replace(cfg, spiking=spiking), p, x)
        assert any("<-hybrid[b" in r["attribution"] for r in rec) == hybrid
    _close(out[True].numpy(), out[False].numpy())


# ------------------------------------------------------- direct coding
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("x_max", [None, 0.7])
def test_quantize_bit_exact(bits, x_max):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(3, 9, 7, 3)).astype(np.float32)
    x[0, 0, 0, :2] = (0.5, -0.5)
    jq, jscale = jdc.quantize(jnp.asarray(x), bits, x_max)
    tq, tscale = tdc.quantize(torch.from_numpy(x), bits, x_max)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        (tq.to(torch.float32) * tscale).numpy(),
        np.asarray(jq.astype(jnp.float32) * jscale))
    np.testing.assert_array_equal(tdc.bit_slice(tq, bits).numpy(),
                                  np.asarray(jdc.bit_slice(jq, bits)))


def test_direct_coded_forms_match_jax():
    rng = np.random.default_rng(3)
    x = rng.random((2, 6, 6, 3), dtype=np.float32)
    w = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)
    wm = rng.normal(size=(3, 4)).astype(np.float32)
    _close(tdc.direct_coded_conv(_t(x), _t(w)).numpy(),
           jdc.direct_coded_conv(jnp.asarray(x), jnp.asarray(w)))
    _close(tdc.direct_coded_conv(_t(x), _t(w)).numpy(),
           tdc.reference_quantized_conv(_t(x), _t(w)).numpy())
    _close(tdc.direct_coded_matmul(_t(x), _t(wm)).numpy(),
           jdc.reference_quantized_matmul(jnp.asarray(x), jnp.asarray(wm)))


# ---------------------------------------------------------------- EAFC
@pytest.mark.parametrize("pool", [2, 4])
def test_eafc_matches_oracle_and_jax(pool):
    rng = np.random.default_rng(pool)
    s = _binary(rng, (3, 8, 8, 5), 0.3)
    w = rng.normal(size=((8 // pool) ** 2 * 5, 7)).astype(np.float32)
    got = teafc.eafc(_t(s), _t(w), pool).numpy()
    _close(got, teafc.avgpool_fc_ref(_t(s), _t(w), pool).numpy())
    _close(got, jeafc.eafc(jnp.asarray(s), jnp.asarray(w), pool))
    assert int(teafc.eafc_event_ops(_t(s), 7)) == int(s.sum()) * 7


# ------------------------------------------------ transposed conv op
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_upsample_events_and_pads_match_jax(k, stride, padding):
    assert teconv._conv_transpose_pads(k, stride, padding) == \
        jeconv._conv_transpose_pads(k, stride, padding)
    s = _binary(np.random.default_rng(k + stride), (2, 5, 4, 3), 0.4)
    np.testing.assert_array_equal(
        teconv.upsample_events(_t(s), stride, k, k + 1, padding).numpy(),
        np.asarray(jeconv.upsample_events(jnp.asarray(s), stride, k, k + 1,
                                          padding)))


@pytest.mark.parametrize("stride,padding", [(2, "SAME"), (2, "VALID"),
                                            (1, "SAME"), (3, "SAME")])
def test_tconv_op_every_backend_matches_jax(stride, padding):
    """Forward and both gradients of the registry `tconv` op, every port
    backend (cuda: zero-insertion + im2col + the predicated kernel's plain
    version), against JAX's `conv_transpose_ref` and `jax.grad`."""
    rng = np.random.default_rng(stride)
    s = _binary(rng, (2, 6, 5, 5), 0.3)
    s[1, :3] = 0                                   # empty patch tiles
    w = rng.normal(size=(3, 3, 5, 4)).astype(np.float32)
    want = jeconv.conv_transpose_ref(jnp.asarray(s), jnp.asarray(w), stride,
                                     padding)
    g = rng.normal(size=want.shape).astype(np.float32)
    _, pull = jax.vjp(lambda a, b: jeconv.conv_transpose_ref(
        a, b, stride, padding), jnp.asarray(s), jnp.asarray(w))
    want_ds, want_dw = pull(jnp.asarray(g))
    for be in dispatch.backend_names("tconv"):
        ts, tw = _t(s, grad=True), _t(w, grad=True)
        with dispatch.use_backend(be):
            out = dispatch.tconv(ts, tw, stride=stride, padding=padding)
        ds, dw = torch.autograd.grad(out, (ts, tw), _t(g))
        _close(out.detach().numpy(), want, f"{be} forward")
        _close(ds.numpy(), want_ds, f"{be} ds")
        _close(dw.numpy(), want_dw, f"{be} dw")


def test_tconv_drops_a_carried_map():
    s = _binary(np.random.default_rng(4), (2, 4, 4, 8), 0.3)
    occ = ops.padded_occupancy(_t(s))
    w = np.random.default_rng(5).normal(size=(3, 3, 8, 2)).astype(np.float32)
    with dispatch.use_backend("cuda"), watch_occupancy_prepasses() as rec:
        got = teconv.conv_transpose(EventTensor(_t(s), occ), _t(w))
    assert rec["calls"] == 1                 # the patch matrix's own pre-pass
    _close(got.numpy(), jeconv.conv_transpose_ref(jnp.asarray(s),
                                                  jnp.asarray(w)))


# ------------------------------------------- kernel 10: predicated matmul
def _clustered(rng, m, k, tile_p=0.5, p=0.3, tile=128):
    tiles = rng.random((-(-m // tile), -(-k // tile))) < tile_p
    tiles[0, 0], tiles[1, :] = True, False        # an all-empty m-tile row
    mask = np.kron(tiles, np.ones((tile, tile)))[:m, :k]
    return (_binary(rng, (m, k), p) * mask).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(300, 200, 60), (256, 256, 128),
                                   (260, 130, 2),
                                   (260, 288, 16)])    # SegNet tconv1's K, N
def test_pred_plain_matches_jax_pallas_interpret(m, k, n):
    """The kernel's plain version (through `ops.spike_matmul`, which masks
    ragged tiles instead of padding) against `spike_matmul_pallas` in
    interpret mode on the zero-padded operands, with the dense pre-pass
    map and with a supplied map that gates an occupied tile off."""
    rng = np.random.default_rng(m + k + n)
    s = _clustered(rng, m, k)
    w = rng.normal(size=(k, n)).astype(np.float32)
    mt, kt, nt = -(-m // 128), -(-k // 128), -(-n // 128)
    sp = np.pad(s, ((0, mt * 128 - m), (0, kt * 128 - k)))
    wp = np.pad(w, ((0, kt * 128 - k), (0, nt * 128 - n)))
    occ = ops.padded_occupancy(_t(s))
    assert (occ[1] == 0).all() and (occ > 0).any()
    gated = occ.clone()
    gated[0, 0] = 0                                # holds events, gated off
    for the_map in (occ, gated):
        want = spike_matmul_pallas(jnp.asarray(sp), jnp.asarray(wp),
                                   jnp.asarray(the_map.numpy()),
                                   interpret=True)[:m, :n]
        got = ops.spike_matmul(_t(s), _t(w), occupancy=the_map)
        _close(got.numpy(), want)
    _close(ops.spike_matmul(_t(s), _t(w)).numpy(),
           jops.spike_matmul(jnp.asarray(s), jnp.asarray(w)))
    assert np.all(ops.spike_matmul(_t(s), _t(w)).numpy()[128:256] == 0)


def test_pred_route_takes_maps_and_rejects_wrong_ones():
    rng = np.random.default_rng(6)
    s = _clustered(rng, 2 * 160, 200).reshape(2, 160, 200)
    w = rng.normal(size=(200, 70)).astype(np.float32)
    occ = ops.padded_occupancy(_t(s))
    with watch_occupancy_prepasses() as rec:
        got = ops.spike_matmul(EventTensor(_t(s), occ), _t(w))
    assert rec["calls"] == 0 and got.shape == (2, 160, 70)
    _close(got.numpy(), s @ w)
    with pytest.raises(ValueError, match="tile grid"):
        ops.spike_matmul(_t(s), _t(w), occupancy=occ[:2])
    with pytest.raises(ValueError, match="tile grid"):
        spike_matmul.spike_matmul_pred(_t(s[0]), _t(w), occ)


def test_multi_bit_input_maps_count_nonzeros():
    """A coded input can sum to zero over a tile; the map counts its
    nonzeros, so the tile still runs."""
    s = np.zeros((130, 140), np.float32)
    s[0, 0], s[0, 1] = 0.5, -0.5
    s[129, 139] = 3.0
    occ = ops.padded_occupancy(_t(s))
    np.testing.assert_array_equal(occ.numpy(), [[2, 0], [0, 1]])
    w = np.random.default_rng(7).normal(size=(140, 3)).astype(np.float32)
    _close(ops.spike_matmul(_t(s), _t(w)).numpy(), s @ w)


# ------------------------------------------------ econv, other routes
def test_econv_scatter_matches_ref_conv_and_jax():
    rng = np.random.default_rng(8)
    s = _binary(rng, (2, 7, 6, 5), 0.3)
    w = rng.normal(size=(3, 3, 5, 4)).astype(np.float32)
    want = teconv.tconv(_t(s), _t(w)).numpy()
    _close(teconv.econv_scatter(_t(s), _t(w)).numpy(), want)
    _close(teconv.econv_gather(_t(s), _t(w)).numpy(), want)
    with dispatch.use_backend("jnp", op="econv"):
        _close(dispatch.econv(_t(s), _t(w)).numpy(), want)
        # Stride 2 is refused by the scatter's gate: as in `repro`, the
        # call warns once, runs the dense conv and is attributed ref<-jnp.
        dispatch.reset_fallback_warnings()
        with pytest.warns(RuntimeWarning, match="stride-1"):
            _close(dispatch.econv(_t(s), _t(w), stride=2).numpy(),
                   teconv.tconv(_t(s), _t(w), stride=2).numpy())
        assert dispatch.resolve_attribution("econv", _t(s), _t(w),
                                            stride=2) == "ref<-jnp"
    with jdispatch.use_backend("jnp", op="econv"), \
            pytest.warns(RuntimeWarning):
        jdispatch.reset_fallback_warnings()
        assert jdispatch.resolve_attribution(
            "econv", jnp.asarray(s), jnp.asarray(w), stride=2) == "ref<-jnp"
    _close(teconv.econv_scatter(_t(s), _t(w), max_events=20).numpy(),
           jeconv.econv_scatter(jnp.asarray(s), jnp.asarray(w),
                                max_events=20))
    assert int(teconv.event_ops(_t(s), 4, 3)) == int(s.sum()) * 36
    assert teconv.tconv_ops(7, 6, 5, 4, 3) == \
        jeconv.tconv_ops(7, 6, 5, 4, 3)


@pytest.mark.parametrize("stride", [1, 2])
def test_econv_pred_route_with_carried_map_matches_jax(stride):
    """im2col + the predicated kernel's plain version, fed the propagated
    patch map (no pre-pass), against JAX's dense conv and its im2col +
    predicated Pallas backend."""
    rng = np.random.default_rng(9)
    s = _binary(rng, (2, 16, 16, 8), 0.05)
    s[1] = 0
    w = (rng.normal(size=(3, 3, 8, 12)) / 5).astype(np.float32)
    jet = jev.EventTensor.from_spikes(jnp.asarray(s))
    tet = EventTensor(_t(s), torch.from_numpy(np.array(jet.occupancy)),
                      chunks=torch.from_numpy(np.array(jet.chunks)))
    want = jdispatch.econv(jet, jnp.asarray(w), stride=stride)
    with jdispatch.use_backend("pallas-interpret", op="econv"):
        want_pred = jdispatch.econv(jet, jnp.asarray(w), stride=stride)
    with dispatch.use_backend("cuda-pred", op="econv"), \
            watch_occupancy_prepasses() as rec:
        got = dispatch.econv(tet, _t(w), stride=stride)
    assert rec["calls"] == 0
    for ref in (want, want_pred):
        _close(got.numpy(), ref)


def test_seg_batch_matches_jax():
    got, want = seg_batch(0, 1, 2, 3, img=20), jseg_batch(0, 1, 2, 3, img=20)
    for key in ("image", "mask"):
        np.testing.assert_array_equal(got[key], want[key])
