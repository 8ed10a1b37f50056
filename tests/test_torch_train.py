"""The port's training path against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
parameters go across through `params_from_numpy`. The port runs on its
`ref` oracles and on its kernel path (`use_backend("cuda")`: the kernel
wrappers' plain versions on CPU tensors, under the same
`autograd.Function`s and registry rules that run the kernels on a card).
Tolerances: op gradients within 1e-5 of max|grad| (1e-6 for SDSA, exact
for max-pool routing); whole-model loss within 1e-5 relative and every
gradient leaf within 1e-5 * max|leaf| + 1e-7; AdamW within 1e-6
relative (one bf16 ulp for bf16 moments); schedules within 1e-7;
3-step losses within 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import SpikingConfig as JSpikingConfig
from repro.core import events as jev
from repro.core import surrogate as jsur
from repro.data.synthetic import class_images as jclass_images
from repro.kernels import dispatch as jdispatch
from repro.models import spikingformer as jsf
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch.configs.base import SpikingConfig
from repro_torch.core import events as tev
from repro_torch.core.econv import tconv
from repro_torch.core.surrogate import spike, spike_st
from repro_torch.data.synthetic import class_images
from repro_torch.kernels import dispatch, ops
from repro_torch.models import spikingformer as tsf
from repro_torch.optim import adamw, schedule

torch.set_num_threads(1)
CASES = [  # (depth, dim, heads, t_steps, v_th), as test_torch_spikingformer
    (1, 32, 4, 2, 1.0),
    (2, 32, 4, 4, 0.5),
]
LR = 1e-3


def _binary(rng, shape, p):
    return (rng.random(shape) < p).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max(initial=0.0)
    assert err <= rel * np.abs(want).max(initial=0.0), \
        f"{what}: max err {err} > {rel} * max|ref| {np.abs(want).max()}"


def _port_vjp(fn, inputs, g, backend):
    """Gradients of <fn(*inputs), g> w.r.t. the inputs, on one backend."""
    xs = [_t(a, grad=True) for a in inputs]
    with dispatch.use_backend(backend):
        out = fn(*xs)
    out = out[0] if isinstance(out, tuple) else out
    return [d.numpy() for d in torch.autograd.grad(out, xs, _t(g))]


def _jax_vjp(fn, inputs, g, backend=None):
    def run(*a):
        out = fn(*a)
        return out[0] if isinstance(out, tuple) else out
    if backend is None:
        _, pull = jax.vjp(run, *map(jnp.asarray, inputs))
    else:
        with jdispatch.use_backend(backend):
            _, pull = jax.vjp(run, *map(jnp.asarray, inputs))
    return [np.asarray(d) for d in pull(jnp.asarray(g))]


# ------------------------------------------------- R1: gradient contract
def test_every_backend_declares_gradient_contract():
    """Training resolves backends as inference does, so every backend the
    resolver can pick, or an override can name, must be differentiable."""
    for op in dispatch.op_names():
        assert set(dispatch.differentiable_backend_names(op)) == \
            set(dispatch.backend_names(op)), op
    assert {"tconv", "econv", "spike_matmul"} <= set(dispatch.op_names())
    assert set(dispatch.differentiable_backend_names("tconv")) == \
        {"ref", "jnp", "cuda"}
    assert {"cuda-pred", "jnp"} <= set(
        dispatch.differentiable_backend_names("econv"))
    assert "cuda-pred" in dispatch.differentiable_backend_names(
        "spike_matmul")


def test_kernel_launch_refuses_operands_autograd_records():
    """A raw kernel wrapper would cut the graph without a word; the launch
    check refuses such operands (the registry launches with recording
    off)."""
    from repro_torch.kernels import _build
    x = torch.zeros(2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        _build.require_cuda("lif", x, dtype=torch.float32)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        _build.require_cuda("lif", x, dtype=torch.float32)


# --------------------------------------------------- R2: ATan surrogate
@pytest.mark.parametrize("alpha", [2.0, 3.0])
def test_spike_surrogate_gradient_matches_jax(alpha):
    v = np.random.default_rng(0).normal(size=(64,)).astype(np.float32)
    v[:3] = (0.0, -1e-7, 1e-7)
    want = jax.grad(lambda a: jnp.sum(jsur.spike(a, alpha) * 3.0))(
        jnp.asarray(v))
    tv = _t(v, grad=True)
    s = spike(tv, alpha)
    np.testing.assert_array_equal(s.detach().numpy(),
                                  np.asarray(jsur.spike(jnp.asarray(v))))
    (got,) = torch.autograd.grad((s * 3.0).sum(), tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    (st,) = torch.autograd.grad((spike_st(tv) * 3.0).sum(), tv)
    assert torch.equal(st, torch.full_like(tv, 3.0))


# ------------------------------------------- (a) fire-op gradients
@pytest.mark.parametrize("soft,alpha", [(True, 2.0), (True, 3.0),
                                        (False, 2.0), (False, 3.0)])
@pytest.mark.parametrize("op", ["lif_scan", "lif_scan_occ"])
def test_fire_op_gradients_match_jax(op, soft, alpha):
    """Port kernel path (the surrogate-backward Function on the plain
    versions) vs JAX pallas-interpret, port ref vs JAX ref."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(4, 2, 8, 40)) * 1.5 + 0.4).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    kw = dict(decay=0.5, v_th=1.0, soft_reset=soft, surrogate_alpha=alpha)
    port_fn = lambda a: getattr(dispatch, op)(a, **kw)   # noqa: E731
    jax_fn = lambda a: getattr(jdispatch, op)(a, **kw)   # noqa: E731
    for port_be, jax_be in (("cuda", "pallas-interpret"), ("ref", "ref")):
        (got,) = _port_vjp(port_fn, [x], g, port_be)
        (want,) = _jax_vjp(jax_fn, [x], g, jax_be)
        assert np.abs(want).max() > 0
        _close(got, want, 1e-5, f"{op} {port_be}")


# ------------------------------------- (b) matmul-form op gradients
def _clustered(rng, m, k, tile_p=0.5, p=0.3, tile=128):
    tiles = rng.random((-(-m // tile), -(-k // tile))) < tile_p
    tiles[0, 0], tiles[-1, -1] = True, False
    mask = np.kron(tiles, np.ones((tile, tile)))[:m, :k]
    return (_binary(rng, (m, k), p) * mask).astype(np.float32), tiles


def test_spike_matmul_gradient_in_skipped_tiles_matches_jax():
    """ds = g @ w.T everywhere, also in the tiles the carried map calls
    empty (autograd through the gated plain version would give 0)."""
    rng = np.random.default_rng(8)
    s, tiles = _clustered(rng, 320, 200)
    s = s.reshape(2, 160, 200)
    w = rng.normal(size=(200, 70)).astype(np.float32)
    g = rng.normal(size=(2, 160, 70)).astype(np.float32)
    occ = ops.padded_occupancy(torch.from_numpy(s))
    assert (occ == 0).any()
    want = _jax_vjp(jdispatch.spike_matmul, [s, w], g)

    def port(a, b):
        return dispatch.spike_matmul(tev.EventTensor(a, occ), b)
    for be in ("cuda", "cuda-pred", "ref"):
        ds, dw = _port_vjp(port, [s, w], g, be)
        _close(ds, want[0], 1e-5, f"ds {be}")
        _close(dw, want[1], 1e-5, f"dw {be}")
        empty = ds.reshape(320, 200)[256:, 128:]     # tile (2, 1): empty
        assert not tiles[2, 1] and np.abs(empty).min() > 0


@pytest.mark.parametrize("stride", [1, 2])
def test_econv_gradient_with_carried_map_matches_jax(stride):
    rng = np.random.default_rng(9)
    s = _binary(rng, (2, 16, 16, 8), 0.05)
    s[1] = 0
    w = (rng.normal(size=(3, 3, 8, 12)) / 5).astype(np.float32)
    g = rng.normal(size=(2, 16 // stride, 16 // stride, 12)).astype(
        np.float32)
    jet = jev.EventTensor.from_spikes(jnp.asarray(s))
    occ = torch.from_numpy(np.array(jet.occupancy))
    chunks = torch.from_numpy(np.array(jet.chunks))
    want = _jax_vjp(lambda a, b: jdispatch.econv(a, b, stride=stride), [s, w],
                    g)

    def port(a, b):
        return dispatch.econv(tev.EventTensor(a, occ, chunks=chunks), b,
                              stride=stride)
    for be in ("cuda", "cuda-pred", "ref") + (("jnp",) if stride == 1
                                                else ()):
        for got, ref, name in zip(_port_vjp(port, [s, w], g, be), want,
                                  ("ds", "dw")):
            _close(got, ref, 1e-5, f"{name} {be}")


# ------------------------------------------------ (c) SDSA with ties
def test_sdsa_gradient_with_ties_matches_jax():
    """The OR status is a max over tokens: binary K*V ties in almost every
    column, and both frameworks split the cotangent evenly over ties."""
    rng = np.random.default_rng(10)
    q, k, v = (_binary(rng, (2, 3, 12, 40), 0.5) for _ in range(3))
    g = rng.normal(size=q.shape).astype(np.float32)
    want = _jax_vjp(jdispatch.sdsa, [q, k, v], g)
    for be in ("cuda", "ref"):
        for got, ref in zip(_port_vjp(dispatch.sdsa, [q, k, v], g, be),
                            want):
            _close(got, ref, 1e-6, f"sdsa {be}")


# ------------------------------------------------ (d) R3: max-pool
def test_max_pool_gradient_goes_to_the_first_maximum_like_jax():
    rng = np.random.default_rng(11)
    s = _binary(rng, (2, 3, 8, 9, 5), 0.5)
    s[0, 0, :2, :2, 0] = (1, 1), (0, 1)          # a tied window
    s[0, 0, 2:4, :2, 0] = 0                      # an all-zero window
    g = rng.normal(size=(2, 3, 4, 4, 5)).astype(np.float32)
    _, pull = jax.vjp(lambda a: jev.max_pool_events(a, 2), jnp.asarray(s))
    (want,) = pull(jnp.asarray(g))
    ts = _t(s, grad=True)
    pooled = tev.max_pool_events(ts, 2)
    np.testing.assert_array_equal(
        pooled.detach().numpy(), np.asarray(jev.max_pool_events(
            jnp.asarray(s), 2)))
    (got,) = torch.autograd.grad(pooled, ts, _t(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0, 0, 0, 0] == g[0, 0, 0, 0, 0] and \
        got[0, 0, 1, 1, 0] == 0


# ------------------------------------------- R4: fp32 convolutions
class _ConvFlags(TorchDispatchMode):
    """Records cuDNN's TF32 flag at every convolution op, backward too."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "convolution" in func.__name__:
            self.seen.append((func.__name__,
                              torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


def test_tconv_runs_forward_and_backward_without_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True       # PyTorch's default
    try:
        s = _t(np.random.default_rng(12).random((2, 6, 6, 3)), grad=True)
        w = _t(np.random.default_rng(13).random((3, 3, 3, 4)), grad=True)
        with _ConvFlags() as mode:
            torch.autograd.grad(tconv(s, w, stride=2).sum(), (s, w))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    names = {name for name, _ in mode.seen}
    assert any("backward" in n for n in names) and \
        any("backward" not in n for n in names), mode.seen
    assert not any(flag for _, flag in mode.seen), mode.seen


# ------------------------------------- (e) + (h) whole SpikingFormer
def _jax_loss(p, x, y, heads, cfg):
    logits = jsf.spikingformer_apply(p, x, n_heads=heads, spiking_cfg=cfg)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "d%d-D%d-T%d" %
                (c[0], c[1], c[3]))
def trajectory(request):
    """JAX: 3 AdamW steps on class_images batches; per step the loss, and
    the first step's gradients."""
    depth, dim, heads, t, v_th = request.param
    jp = jsf.spikingformer_init(jax.random.PRNGKey(0), depth, dim)
    cfg = JSpikingConfig(t_steps=t, lif_vth=v_th)
    ocfg = jadamw.AdamWConfig(lr=LR)

    @jax.jit
    def step(p, o, x, y):
        loss, g = jax.value_and_grad(_jax_loss)(p, x, y, heads, cfg)
        p, o = jadamw.update(g, o, p, ocfg)
        return p, o, loss, g

    init = jax.tree_util.tree_map(np.asarray, jp)
    opt = jadamw.init(jp, ocfg)
    losses, grads0 = [], None
    for i in range(3):
        b = jclass_images(0, 0, i, 2)
        jp, opt, loss, g = step(jp, opt, jnp.asarray(b["image"]),
                                jnp.asarray(b["label"]))
        losses.append(float(loss))
        grads0 = grads0 or jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, g))
    return dict(init=init, heads=heads, v_th=v_th,
                cfg=SpikingConfig(t_steps=t, lif_vth=v_th), losses=losses,
                grads0=grads0)


def _port_step(params, opt, step, heads, cfg):
    b = class_images(0, 0, step, 2)
    leaves = adamw.leaves(params)
    logits = tsf.spikingformer_apply(params, torch.from_numpy(b["image"]),
                                     n_heads=heads, spiking_cfg=cfg)
    loss = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(b["label"]).long())
    grads = torch.autograd.grad(loss, leaves)
    _, opt = adamw.update(list(grads), opt, leaves, adamw.AdamWConfig(lr=LR))
    return loss.item(), grads, opt


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


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_spikingformer_training_matches_jax(trajectory, backend,
                                            monkeypatch):
    """(e) the first step's loss and every gradient leaf, (h) the losses
    of 3 AdamW steps."""
    drives = []
    for name in ("lif_scan", "lif_scan_occ"):
        orig = getattr(dispatch, name)

        def rec(x, *a, _orig=orig, **kw):
            drives.append(x.detach().clone())
            return _orig(x, *a, **kw)
        monkeypatch.setattr(dispatch, name, rec)
    params = tsf.params_from_numpy(trajectory["init"], device="cpu")
    for leaf in adamw.leaves(params):
        leaf.requires_grad_(True)
    opt = adamw.init(params, adamw.AdamWConfig(lr=LR))
    losses = []
    with dispatch.use_backend(backend):
        for i in range(3):
            loss, grads, opt = _port_step(params, opt, i, trajectory["heads"],
                                          trajectory["cfg"])
            losses.append(loss)
            if i == 0:
                want = trajectory["losses"][0]
                assert abs(loss - want) <= 1e-5 * abs(want)
                assert len(grads) == len(trajectory["grads0"])
                for j, (got, ref) in enumerate(zip(grads,
                                                   trajectory["grads0"])):
                    err = np.abs(got.numpy() - ref).max()
                    assert err <= 1e-5 * np.abs(ref).max() + 1e-7, \
                        f"leaf {j} {ref.shape}: {err}"
    np.testing.assert_allclose(
        losses, trajectory["losses"], rtol=1e-4,
        err_msg=f"smallest |v - v_th| margin "
                f"{_min_margin(drives, trajectory['v_th'])}")


# ------------------------------------------------------- (f) AdamW
def _tree(rng):
    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return {"head": f(8, 16), "bias": f(16),
            "blocks": [{"w": f(4, 3, 2)}, {"w": f(5, 5)}]}


def _bf16_ulp(a):
    a = np.abs(a)
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-38)))
                                   - 7), 2.0 ** -133)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(state_dtype):
    rng = np.random.default_rng(14)
    p0 = _tree(rng)
    grads = [jax.tree_util.tree_map(lambda a, s=s: a * s, _tree(rng))
             for s in (0.3, 0.01, 2.0)]      # clipping off, off, on
    jcfg = jadamw.AdamWConfig(lr=LR, state_dtype=state_dtype)
    tcfg = adamw.AdamWConfig(lr=LR, state_dtype=state_dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jo = jadamw.init(jp, jcfg)
    tp = tsf.params_from_numpy(p0, device="cpu")
    to = adamw.init(tp, tcfg)
    for i, g in enumerate(grads):
        jp, jo = jadamw.update(jax.tree_util.tree_map(jnp.asarray, g), jo,
                               jp, jcfg, jschedule.warmup_cosine(
                                   i + 1, warmup_steps=2, total_steps=5))
        tp, to = adamw.update(tsf.params_from_numpy(g, device="cpu"), to,
                              tp, tcfg, schedule.warmup_cosine(
                                  i + 1, warmup_steps=2, total_steps=5))
    assert int(to.step) == int(jo.step) == 3
    got, want = tsf.params_to_numpy(to), tsf.params_to_numpy(
        tsf.params_from_numpy(jo, device="cpu"))
    assert to.mu["head"].dtype == getattr(torch, state_dtype)
    for a, b in zip(jax.tree_util.tree_leaves(tsf.params_to_numpy(tp)),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(jax.tree_util.tree_leaves([got.mu, got.nu]),
                    jax.tree_util.tree_leaves([want.mu, want.nu])):
        if state_dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())
        else:
            assert np.all(np.abs(a - b) <= _bf16_ulp(b))


# ---------------------------------------------------- (g) schedules
@pytest.mark.parametrize("warmup,total", [(100, 10_000), (1, 3), (0, 50)])
def test_schedules_match_jax(warmup, total):
    for step in (0, 1, 2, 50, 99, 100, 101, 5000, 10_000, 12_000):
        want = jschedule.warmup_cosine(step, warmup_steps=warmup,
                                       total_steps=total, min_ratio=0.1)
        got = schedule.warmup_cosine(step, warmup_steps=warmup,
                                     total_steps=total, min_ratio=0.1)
        assert got.dtype == torch.float32
        assert abs(got.item() - float(want)) <= 1e-7, step
    assert schedule.constant(torch.tensor(3), 0.5).item() == \
        float(jschedule.constant(3, 0.5))


def test_class_images_match_jax():
    want = jclass_images(0, 1, 2, 3)
    got = class_images(0, 1, 2, 3)
    for key in ("image", "label"):
        np.testing.assert_array_equal(got[key], want[key])
