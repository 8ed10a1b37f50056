"""The port's registry resolution against `repro`'s, on the CPU.

Mirrors `tests/test_dispatch_parity.py` where it applies to the port: a
refused `supports` gate degrades along the declared `fallback=` chain,
then to `ref`, warning once per edge and attributing the result
``<chosen><-<requested>``; an unknown override name lands on `ref`; and
automatic selection walks the candidates in priority order. The port's
`cuda` routes take the place of `repro`'s `pallas-interpret` ones: on CPU
tensors the kernel wrappers run their plain versions, so the same
resolution path runs as on the card. Values are held to `ref` (and to
`repro`) within 1e-5; attributions exactly.

On the card (the platform read as `cuda`) the port departs from `repro`:
a degrade stays on the kernel routes or raises, so a plain version never
runs in place of a kernel there. A kernel that fails to build or launch
raises everywhere.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro_torch.configs.base import SpikingConfig
from repro_torch.configs.registry import paper_cnn_configs
from repro_torch.core.spikes import pack_spikes_padded
from repro_torch.kernels import _build, dispatch
from repro_torch.models import cnn as tcnn
from repro_torch.models import spikingformer as tsf

torch.set_num_threads(1)
ATOL = 1e-5
# The port's kernel route and its counterpart in `repro` on the CPU.
JAX_NAME = {"cuda": "pallas-interpret", "ref": "ref"}


@pytest.fixture(autouse=True)
def _clean_resolution(monkeypatch):
    """No ambient override, and every warn-once edge re-armed, in both
    registries."""
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    monkeypatch.delenv(jdispatch.ENV_VAR, raising=False)
    dispatch.reset_fallback_warnings()
    jdispatch.reset_fallback_warnings()


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=ATOL)


def _clustered(rng, m, k, p=0.4):
    tiles = rng.random((-(-m // 128), -(-k // 128))) < 0.6
    mask = np.kron(tiles, np.ones((128, 128)))[:m, :k]
    return ((rng.random((m, k)) < p) * mask).astype(np.float32)


def _chain_edges():
    return [(op, name, dispatch.get_backend(op, name).fallback)
            for op in dispatch.op_names()
            for name in dispatch.backend_names(op)
            if dispatch.get_backend(op, name).fallback is not None]


# ------------------------------------------------------------ the chains
def test_declared_chains_mirror_the_reference():
    assert set(_chain_edges()) == {
        ("spike_matmul", "cuda-packed-pipe", "cuda-packed"),
        ("spike_matmul", "cuda-pipe", "cuda"),
        ("econv", "cuda-packed-pipe", "cuda-packed"),
        ("econv", "cuda-pipe", "cuda"),
        ("spike_matmul", "cuda-packed", "cuda"),
        ("spike_matmul", "cuda", "cuda-pred"),
        ("econv", "cuda-packed", "cuda"),
        ("econv", "cuda", "cuda-pred"),
        ("apec_matmul", "cuda-packed-pipe", "cuda-packed"),
        ("apec_matmul", "cuda-pipe", "cuda"),
        ("apec_matmul", "cuda-packed", "cuda"),
        ("apec_matmul", "cuda", "cuda-pred")}
    text = dispatch.table()
    for op in dispatch.op_names():
        assert op in text
    assert "cuda-packed(p30,grad,packed,->cuda)" in text
    assert "cuda-packed-pipe(p31,grad,packed,->cuda-packed)" in text
    assert "cuda-pipe(p26,grad,->cuda)" in text


@pytest.mark.parametrize("op,name,nxt", _chain_edges())
def test_every_chain_edge_warns_once_and_is_attributed(op, name, nxt,
                                                       monkeypatch):
    """Each declared edge, forced by a gate that refuses every call: the
    override degrades to the next link with one warning per edge, is
    attributed ``<next><-<requested>``, and runs the next link's values."""
    import dataclasses
    spec = dispatch._REGISTRY[op]
    monkeypatch.setitem(spec.backends, name, dataclasses.replace(
        spec.backends[name], supports=lambda *a, **k: "refused here"))
    args, kwargs = dispatch.example_inputs(op, "cpu")
    with dispatch.use_backend(name, op=op):
        with pytest.warns(RuntimeWarning, match=f"degrading to '{nxt}'"):
            assert dispatch.resolve_attribution(op, *args, **kwargs) == \
                f"{nxt}<-{name}"
        with warnings.catch_warnings():
            warnings.simplefilter("error")           # the edge is spent
            got = dispatch.dispatch(op, *args, **kwargs)
        dispatch.reset_fallback_warnings()
        with pytest.warns(RuntimeWarning, match="refused here"):
            dispatch.resolve(op, *args, **kwargs)
    want = dispatch.get_backend(op, nxt).fn(*args, **kwargs)
    for a, b in zip(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want]):
        _close(a, b)


def test_a_refused_packed_call_walks_the_chain_to_the_predicated_kernel():
    """The packed APEC call at g=256 (128 % g != 0 refuses both fused
    routes) walks cuda-packed -> cuda -> cuda-pred, each edge warned, and
    runs the predicated route on the unpacked words; repro's packed-csr
    walks packed-csr -> pallas-csr -> pallas the same way."""
    rng = np.random.default_rng(3)
    s = _clustered(rng, 512, 96)
    w = rng.normal(size=(96, 24)).astype(np.float32)
    words = pack_spikes_padded(torch.from_numpy(s))
    kw = {"g": 256, "packed_k": 96}
    with dispatch.use_backend("cuda-packed", op="apec_matmul"), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        att = dispatch.resolve_attribution("apec_matmul", words,
                                           torch.from_numpy(w), **kw)
        out = dispatch.dispatch("apec_matmul", words, torch.from_numpy(w),
                                **kw)
    assert att == "cuda-pred+unpack<-cuda-packed"
    msgs = " ".join(str(c.message) for c in caught)
    assert "degrading to 'cuda'" in msgs and \
        "degrading to 'cuda-pred'" in msgs and "unpack" in msgs
    _close(out, s @ w)
    with jdispatch.use_backend("packed-csr-interpret", op="apec_matmul"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jatt = jdispatch.resolve_attribution(
            "apec_matmul", jax.lax.bitcast_convert_type(
                jnp.asarray(words.view(torch.int32).numpy()), jnp.uint32),
            jnp.asarray(w), **kw)
    assert jatt == "pallas-interpret+unpack<-packed-csr-interpret"


# ---------------------------------------------------------- overrides
def test_unknown_override_name_falls_to_ref_with_a_warning(monkeypatch):
    args, kwargs = dispatch.example_inputs("sdsa", "cpu")
    want = dispatch.get_backend("sdsa", "ref").fn(*args, **kwargs)
    with dispatch.use_backend("no-such-backend", op="sdsa"):
        with pytest.warns(RuntimeWarning, match="not registered"):
            got = dispatch.dispatch("sdsa", *args, **kwargs)
        assert dispatch.resolve_attribution("sdsa", *args, **kwargs) == \
            "ref<-no-such-backend"
    assert torch.equal(got, want)
    monkeypatch.setenv(dispatch.ENV_VAR, "no-such-backend")
    with pytest.warns(RuntimeWarning, match="not registered"):
        assert dispatch.resolve("lif_scan", torch.zeros(2, 3)).name == "ref"
    jargs, jkw = jdispatch.example_inputs("sdsa", jax.random.PRNGKey(0))
    with jdispatch.use_backend("no-such-backend", op="sdsa"), \
            pytest.warns(RuntimeWarning, match="not registered"):
        assert jdispatch.resolve_attribution("sdsa", *jargs, **jkw) == \
            "ref<-no-such-backend"


def test_resolved_backends_is_a_snapshot_that_keeps_the_warnings_armed():
    q = torch.zeros(2, 4, 8)
    with dispatch.use_backend("cuda"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            snap = dispatch.resolved_backends("cpu")
        assert set(snap.values()) == {"cuda"}
        with pytest.warns(RuntimeWarning, match="mode='or'"):
            dispatch.sdsa(q, q, q, mode="sum")


def test_watch_resolutions_records_each_call():
    q, x = torch.zeros(2, 4, 8), torch.zeros(2, 3, 16)
    with dispatch.watch_resolutions() as rec, \
            dispatch.use_backend("cuda"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dispatch.sdsa(q, q, q, mode="sum")
        dispatch.lif_scan_occ(x)
    assert rec == [
        {"op": "sdsa", "backend": "ref", "attribution": "ref<-cuda"},
        {"op": "lif_scan_occ", "backend": "cuda", "attribution": "cuda"}]


# --------------------------------------------------- automatic selection
def test_automatic_selection_degrades_on_a_capability_failure():
    """On CPU tensors a refused automatic candidate warns and the next in
    priority order runs (`ref` at the end), as in `repro`; an op whose only
    CPU candidate is `ref` resolves there silently."""
    q = torch.zeros(2, 4, 8)
    s, w = torch.zeros(2, 10, 32), torch.zeros(32, 8)
    # the overlap-reuse form refuses g=3 (10 % 3): ref, warned
    with pytest.warns(RuntimeWarning, match="not divisible"):
        assert dispatch.resolve_attribution("apec_matmul", s, w, g=3) == \
            "ref<-jnp"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert dispatch.resolve_attribution("sdsa", q, q, q,
                                            mode="sum") == "ref"
    js, jw = jnp.zeros((2, 10, 32)), jnp.zeros((32, 8))
    with pytest.warns(RuntimeWarning, match="not divisible"):
        assert jdispatch.resolve_attribution("apec_matmul", js, jw, g=3) == \
            "ref<-jnp"


def _card(monkeypatch):
    monkeypatch.setattr(dispatch, "_platform", lambda args: "cuda")


def test_on_the_card_automatic_selection_stays_on_the_kernels(monkeypatch):
    """With the platform read as `cuda`, a refused kernel walks its
    declared chain to the next kernel (one warning), and where no kernel
    is left the call raises: neither `jnp` nor `ref` stands in."""
    _card(monkeypatch)
    q = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="mode='or'.*no kernel route"):
        dispatch.resolve("sdsa", q, q, q, mode="sum")
    s, w = torch.zeros(2, 256, 32), torch.zeros(32, 8)
    # the fused routes (pipelined, then serial) refuse g=256; the
    # predicated kernel takes it (where the CPU, and repro, would run the
    # overlap-reuse `jnp` form)
    with pytest.warns(RuntimeWarning, match="degrading to 'cuda-pred'"):
        assert dispatch.resolve_attribution("apec_matmul", s, w, g=256) == \
            "cuda-pred<-cuda-pipe"
    with pytest.raises(ValueError, match="not divisible"):
        dispatch.resolve("apec_matmul", torch.zeros(2, 10, 32), w, g=3)


@pytest.mark.parametrize("packed", [False, True])
def test_on_the_card_no_walk_ends_at_a_plain_route(packed, monkeypatch):
    """A refused chain, an unknown override name and a refused manual
    `jnp` route raise on the card, packed payloads included; an explicit
    `ref` override still runs `ref` (the oracle the comparisons use)."""
    _card(monkeypatch)
    rng = np.random.default_rng(5)
    s = torch.from_numpy(_clustered(rng, 20, 64))
    w = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    args, kw = ((pack_spikes_padded(s), w), {"packed_k": 64}) if packed \
        else ((s, w), {})
    with pytest.raises(ValueError, match="not divisible"):
        dispatch.resolve("apec_matmul", *args, g=3, **kw)
    with dispatch.use_backend("cuda-packed" if packed else "cuda",
                              op="apec_matmul"), \
            pytest.raises(ValueError, match="not divisible"):
        dispatch.dispatch("apec_matmul", *args, g=3, **kw)
    with dispatch.use_backend("no-such-backend", op="spike_matmul"), \
            pytest.raises(ValueError, match="not registered"):
        dispatch.resolve("spike_matmul", *args, **kw)
    x = torch.zeros(1, 6, 6, 8)
    with dispatch.use_backend("jnp", op="econv"), \
            pytest.raises(ValueError, match="stride-1"):
        dispatch.econv(x, torch.zeros(3, 3, 8, 4), stride=2)
    with dispatch.use_backend("ref", op="spike_matmul"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")          # the explicit unpack shim
        assert dispatch.resolve_attribution("spike_matmul", *args, **kw) == \
            ("ref+unpack" if packed else "ref")
        _close(dispatch.dispatch("spike_matmul", *args, **kw), s @ w)


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_vgg11_runs_at_any_batch_under_the_cuda_override(batch,
                                                         monkeypatch):
    """VGG11's last two fires run at 2x2, so R = 4B is ragged at B=1 and
    B=3. `repro` gates its fused fire off there (``ref<-pallas-interpret``);
    the port's fire kernel masks the ragged rows, so every fire stays on
    ``cuda`` with no warning, on the card too, and the logits equal the ref
    forward's."""
    cfg = paper_cnn_configs()["vgg11"]
    p = tcnn.vgg11_init(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    x = torch.from_numpy(np.random.default_rng(batch).random(
        (batch, 32, 32, 3)).astype(np.float32))
    drives = []
    orig = dispatch.dispatch

    def record(op, *args, **kwargs):
        if op == "lif_scan_occ":
            drives.append(tuple(args[0].shape))
        return orig(op, *args, **kwargs)
    with torch.inference_mode(), dispatch.watch_resolutions() as rec, \
            dispatch.use_backend("cuda"), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dispatch.dispatch = record
        try:
            got = tcnn.vgg11_apply(cfg, p, x)
        finally:
            dispatch.dispatch = orig
    with torch.inference_mode(), dispatch.use_backend("ref"):
        want = tcnn.vgg11_apply(cfg, p, x)
    _close(got, want)
    fires = [r["attribution"] for r in rec if r["op"] == "lif_scan_occ"]
    assert fires == ["cuda"] * len(fires)
    assert [d[2:-1] for d in drives[-2:]] == [(2, 2), (2, 2)]
    assert not [c for c in caught if "exspike" in str(c.message)]
    # repro resolves the aligned fires the same way and gates the ragged
    # ones off to its ref
    for shape in drives:
        with jdispatch.use_backend("pallas-interpret"), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jatt = jdispatch.resolve_attribution("lif_scan_occ",
                                                 jnp.zeros(shape))
        ragged = np.prod(shape[1:-1]) % 8 != 0
        assert ragged == (batch % 2 == 1 and shape[2:-1] == (2, 2))
        assert jatt == ("ref<-pallas-interpret" if ragged
                        else JAX_NAME["cuda"])
    _card(monkeypatch)
    assert {dispatch.resolve_attribution("lif_scan_occ", torch.zeros(d))
            for d in drives} == {"cuda"}


def test_sdsa_sum_mode_degrades_sdsa_to_ref(monkeypatch):
    """The trainable SDSA form has no bitwise kernel: under the cuda
    override on CPU tensors `sdsa` degrades to ``ref<-cuda`` and the
    forward equals the ref forward; repro attributes it
    ``ref<-pallas-interpret``. On the card the forward raises instead."""
    cfg = SpikingConfig(t_steps=2, sdsa_mode="sum", lif_vth=0.5)
    p = tsf.spikingformer_init(1, 32, generator=torch.Generator()
                               .manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode(), dispatch.watch_resolutions() as rec, \
            dispatch.use_backend("cuda"):
        with pytest.warns(RuntimeWarning, match="mode='or'"):
            got = tsf.spikingformer_apply(p, x, n_heads=4, spiking_cfg=cfg)
    with torch.inference_mode(), dispatch.use_backend("ref"):
        want = tsf.spikingformer_apply(p, x, n_heads=4, spiking_cfg=cfg)
    _close(got, want)
    sdsa = {r["attribution"] for r in rec if r["op"] == "sdsa"}
    assert sdsa == {"ref<-cuda"}
    jargs, _ = jdispatch.example_inputs("sdsa", jax.random.PRNGKey(0))
    with jdispatch.use_backend("pallas-interpret"), \
            pytest.warns(RuntimeWarning):
        assert jdispatch.resolve_attribution("sdsa", *jargs, mode="sum") == \
            "ref<-pallas-interpret"
    _card(monkeypatch)
    with torch.inference_mode(), pytest.raises(ValueError, match="mode='or'"):
        tsf.spikingformer_apply(p, x, n_heads=4, spiking_cfg=cfg)


# ----------------------------------------------------- failures still raise
def test_a_kernel_that_fails_to_build_or_launch_still_raises(monkeypatch,
                                                             tmp_path):
    """Resolution degrades only on a refused gate: an exception from the
    chosen backend (a build without nvcc, a launch error) reaches the
    caller, under an override and under automatic selection alike."""
    import dataclasses
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _build.check(700, "lif")

    def broken(*args, **kwargs):
        return _build.library()          # what a CUDA wrapper does first
    spec = dispatch._REGISTRY["lif_scan"]
    monkeypatch.setitem(spec.backends, "cuda", dataclasses.replace(
        spec.backends["cuda"], fn=broken))
    x = torch.zeros(2, 8)
    with dispatch.use_backend("cuda"), pytest.raises(RuntimeError,
                                                     match="nvcc"):
        dispatch.lif_scan(x)
    monkeypatch.setattr(dispatch, "_platform", lambda args: "cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        dispatch.lif_scan(x)


# ----------------------------------------------------- APEC group sizes
@pytest.mark.parametrize("g", [1, 16, 128])
@pytest.mark.parametrize("packed", [False, True])
def test_apec_fused_routes_take_every_group_dividing_128(g, packed,
                                                         monkeypatch):
    """At g=1, 16 and 128 the fused routes accept the call with no warning
    (automatic selection on the card, which picks the pipelined route,
    and the serial route's override alike) and their plain versions equal
    repro's pallas-csr-interpret output."""
    rng = np.random.default_rng(g)
    m, k, n = 1024, 200, 40
    s = _clustered(rng, m, k)
    grp = s.reshape(m // g, g, k)
    grp[::3] = grp[::3, :1]                   # some fully overlapping groups
    s = grp.reshape(m, k)
    w = rng.normal(size=(k, n)).astype(np.float32)
    ts, tw = torch.from_numpy(s), torch.from_numpy(w)
    if packed:
        args, kw, name = (pack_spikes_padded(ts), tw), \
            {"g": g, "packed_k": k}, "cuda-packed"
    else:
        args, kw, name = (ts, tw), {"g": g}, "cuda"
    auto = name + "-pipe"
    want = np.asarray(jops.apec_matmul_csr(jnp.asarray(s), jnp.asarray(w),
                                           g))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with dispatch.use_backend(name, op="apec_matmul"):
            assert dispatch.resolve_attribution("apec_matmul", *args,
                                                **kw) == name
            got = dispatch.dispatch("apec_matmul", *args, **kw)
        monkeypatch.setattr(dispatch, "_platform", lambda a: "cuda")
        assert dispatch.resolve_attribution("apec_matmul", *args,
                                            **kw) == auto
    tol = 1e-5 * np.abs(want).max() + 1e-5
    assert np.abs(got.numpy() - want).max() <= tol
    _close(got, s @ w)
