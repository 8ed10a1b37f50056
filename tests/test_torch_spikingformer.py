"""SpikingFormer end to end: repro_torch against the JAX package with the
same params (moved through numpy) and the same images, on the CPU.

The port runs twice: on its `ref` oracles (the CPU default) and on its
kernel path (`use_backend("cuda")`, the kernels' plain versions on CPU
tensors, which walk the carried maps and CSR work lists). Logits must
agree with the JAX forward within 1e-5 and every `collect_stats` spike
map exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SpikingConfig as JSpikingConfig
from repro.models import spikingformer as jsf
from repro_torch.configs.base import SpikingConfig
from repro_torch.core.spikes import watch_occupancy_prepasses
from repro_torch.kernels import dispatch
from repro_torch.models import spikingformer as tsf

torch.set_num_threads(1)
ATOL = 1e-5
CASES = [  # (depth, dim, heads, t_steps, v_th)
    (1, 32, 4, 2, 1.0),
    (2, 32, 4, 4, 0.5),
]


def _jax_params(depth, dim):
    return jsf.spikingformer_init(jax.random.PRNGKey(0), depth, dim)


def _images(batch=2, seed=1):
    return np.random.default_rng(seed).random((batch, 32, 32, 3),
                                              dtype=np.float32)


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


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "d%d-D%d-T%d" %
                (c[0], c[1], c[3]))
def case(request):
    depth, dim, heads, t, v_th = request.param
    jp = _jax_params(depth, dim)
    x = _images()
    logits, stats = jsf.spikingformer_apply(
        jp, jnp.asarray(x), n_heads=heads,
        spiking_cfg=JSpikingConfig(t_steps=t, lif_vth=v_th),
        collect_stats=True)
    params = tsf.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return dict(params=params, x=torch.from_numpy(x), heads=heads,
                cfg=SpikingConfig(t_steps=t, lif_vth=v_th), v_th=v_th,
                logits=np.asarray(logits),
                stats=[np.asarray(s) for s in stats])


def _run_port(case, monkeypatch=None):
    drives = []
    if monkeypatch is not None:          # record every fire stage's drive
        for name in ("lif_scan", "lif_scan_occ"):
            orig = getattr(dispatch, name)

            def rec(x, *a, _orig=orig, **kw):
                drives.append(x.detach().clone())
                return _orig(x, *a, **kw)
            monkeypatch.setattr(dispatch, name, rec)
    with torch.inference_mode():
        logits, stats = tsf.spikingformer_apply(
            case["params"], case["x"], n_heads=case["heads"],
            spiking_cfg=case["cfg"], collect_stats=True)
    return logits, stats, drives


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_logits_and_spike_maps_match_jax(case, backend, monkeypatch):
    with dispatch.use_backend(backend):
        logits, stats, drives = _run_port(case, monkeypatch)
    assert len(stats) == len(case["stats"])
    for i, (got, want) in enumerate(zip(stats, case["stats"])):
        n_diff = int((got.numpy() != want).sum())
        assert n_diff == 0, (
            f"stage {i}: {n_diff} spikes differ; smallest |v - v_th| "
            f"margin {_min_margin(drives, case['v_th'])}")
    np.testing.assert_allclose(logits.numpy(), case["logits"], atol=ATOL,
                               rtol=ATOL)


def test_kernel_path_rederives_no_occupancy(case):
    """Between spiking layers the kernel path consumes carried maps only;
    the ref path pays one chunk pre-pass per fire-with-counts stage."""
    with dispatch.use_backend("cuda"), watch_occupancy_prepasses() as rec:
        _run_port(case)
    assert rec["calls"] == 0
    with watch_occupancy_prepasses() as rec:
        _run_port(case)
    depth = len(case["params"]["blocks"])
    assert rec["calls"] == 4 + 2 * depth


def test_port_init_matches_jax_tree_shapes():
    jp = _jax_params(2, 32)
    tp = tsf.spikingformer_init(2, 32, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
    jleaves, jtree = jax.tree_util.tree_flatten(jp)
    tleaves, ttree = jax.tree_util.tree_flatten(tp)
    assert jtree == ttree
    assert [tuple(a.shape) for a in jleaves] == \
        [tuple(t.shape) for t in tleaves]
    assert all(t.dtype == torch.float32 for t in tleaves)
    again = tsf.spikingformer_init(2, 32, generator=torch.Generator()
                                   .manual_seed(0), device="cpu")
    assert torch.equal(again["head"], tp["head"])


def test_unported_modes_raise_with_their_roadmap_item():
    """The mode this test held refused, `SpikingConfig(hybrid=True)`
    (ROADMAP queue 1 item 4), is ported: it runs, routing the carried
    maps' calls, and its logits equal the default forward's within ATOL
    (tests/test_torch_hybrid.py holds it to the automatic forward bit for
    bit and to repro's)."""
    p = tsf.spikingformer_init(1, 32, generator=torch.Generator()
                               .manual_seed(0), device="cpu")
    x = torch.from_numpy(_images(batch=1))
    with torch.inference_mode(), dispatch.watch_resolutions() as rec:
        hybrid = tsf.spikingformer_apply(
            p, x, spiking_cfg=SpikingConfig(hybrid=True))
    with torch.inference_mode():
        auto = tsf.spikingformer_apply(p, x, spiking_cfg=SpikingConfig())
    assert any("<-hybrid[b" in r["attribution"] for r in rec)
    np.testing.assert_allclose(hybrid.numpy(), auto.numpy(), atol=ATOL,
                               rtol=ATOL)


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsf.spikingformer_init(1, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsf.params_from_numpy({"head": np.zeros((2, 2))})
