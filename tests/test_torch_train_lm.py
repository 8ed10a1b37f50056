"""The LM's training path in repro_torch against the JAX package, on the
CPU: the bf16 residual and surrogate fires, `lm_batch` and the sharded
pipeline, `chunked_ce_loss`, `loss_fn` with its gradients, `cfg.remat`,
`grad_compress`, `make_train_step`, `train_loop` and its CLI.

Models are the reduced TinyLlama config (`get_reduced`: 2 layers, d 64,
4 / 2 heads, d_ff 5632, vocab 512, T=2) and `tests/test_system.py`'s
TINY; params come across through `params_from_numpy`, inputs are made
with numpy from a seed. The port runs its `ref` oracles and its kernel
path (`use_backend("cuda")`: the kernel wrappers' plain versions on CPU
tensors, under the same `autograd.Function`s that launch the kernels on
a card).

Tolerances:
  * the plain bf16 fires against `_lif_fwd_pallas` / `_lif_bwd_pallas`
    in interpret mode: spikes, `vres` (f32) and `dx` (bf16) exact. The
    reference is compiled at `--xla_backend_optimization_level=0`, the
    suite's setting (tests/conftest.py): at higher levels XLA's CPU
    backend contracts `g*sg + u*dreset` into one FMA, which the TPU
    kernel as written, the CUDA kernel and the plain version do not;
  * `lm_batch`, the pipeline's batches, spikes of f32 trees: exact;
  * `chunked_ce_loss` and its gradients: 1e-5 of max|ref|;
  * `loss_fn` on f32-cast trees: loss within 1e-5 relative, every
    gradient leaf within 1e-5 * max|leaf| + 1e-7 (test_torch_train.py's
    whole-model tolerance); on bf16 trees BF16_TOL of max|ref| for the
    loss and each leaf: XLA and oneDNN round a bf16 matmul's f32 sum to
    8 mantissa bits after summing in different orders, so an output can
    land one bf16 ulp (2^-8 relative) apart, and a drive at the
    threshold flips a spike, which moves one row of the next drive and
    its gradients by a weight row;
  * `remat` none / full / dots, and a resumed run against an
    uninterrupted one: bit for bit;
  * 3 `make_train_step` steps on f32-cast trees: losses within 1e-5
    relative, params within STEP_PARAM_TOL = 2e-4 absolute, a fifth of
    lr: AdamW's first update is m/sqrt(v) = sign(g), so an element whose
    gradient is near 0 moves by lr either way, and under compression a
    wire value q = round(g/scale) one apart moves an update (the largest
    gap at these seeds is 8.8e-5, compressed; 1.7e-5 without);
  * `grad_compress`: wire values and error feedback exact, scales within
    1 f32 ulp.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import LMConfig as JLMConfig
from repro.configs.base import SpikingConfig as JSpikingConfig
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.kernels import dispatch as jdispatch
from repro.kernels.lif_scan import _lif_bwd_pallas, _lif_fwd_pallas
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LMConfig, SpikingConfig
from repro_torch.data import pipeline, synthetic
from repro_torch.kernels import dispatch, lif_scan, ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models.layers import params_from_numpy
from repro_torch.optim import adamw, grad_compress

torch.set_num_threads(2)
ARCH = "tinyllama-1.1b"
CFG = jreg.get_reduced(ARCH)
TCFG = treg.get_reduced(ARCH)
TINY_FIELDS = dict(name="sys-tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                   remat="none", loss_chunk=16)
JTINY = JLMConfig(spiking=JSpikingConfig(t_steps=2), **TINY_FIELDS)
TINY = LMConfig(spiking=SpikingConfig(t_steps=2), **TINY_FIELDS)
F32_TOL = 1e-5
BF16_TOL = 2e-2
LR = 1e-3
STEP_PARAM_TOL = 2e-4


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _batch(step, b=2, s=16, vocab=CFG.vocab, seed=0):
    return synthetic.lm_batch(seed, 0, step, b, s, vocab)


def _tbatch(host):
    return pipeline.device_put_batch(host, "cpu")


def _jbatch(host):
    return {k: jnp.asarray(v) for k, v in host.items()}


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_params(CFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=["f32", "bf16"])
def trees(request, jparams):
    """(dtype tag, repro params, a function making fresh port params)."""
    jp = jparams
    if request.param == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    host = _np(jp)
    return request.param, jp, lambda: params_from_numpy(host, device="cpu")


# ------------------------------------------------- step 0: the bf16 fires
def _bf16(a):
    """numpy f32 -> (the same values as a bf16 jax array, torch bf16)."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(_f(j)).bfloat16()


@pytest.mark.parametrize("shape,block", [((2, 256, 256), (128, 128)),
                                         ((3, 7, 37), (7, 37))],
                         ids=["aligned", "ragged"])
@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("alpha", [2.0, 4.0])
def test_bf16_fires_match_the_pallas_kernels_exactly(shape, block, soft,
                                                      alpha):
    """The residual fire's spikes (bf16) and vres (f32), and the surrogate
    backward's dx (bf16) from f32 u, equal the TPU kernels bit for bit on
    a bf16 drive and cotangent; P = 7*37 is not a multiple of the CUDA
    kernels' 8-lane vector."""
    rng = np.random.default_rng(sum(shape) + int(soft) + int(alpha))
    jx, tx = _bf16(rng.normal(0.0, 1.3, shape).astype(np.float32))
    jg, tg = _bf16(rng.normal(0.0, 1.0, shape).astype(np.float32))
    kw = dict(decay=0.5, v_th=1.0, soft_reset=soft)
    js, jvres = _lif_fwd_pallas(jx, block_m=block[0], block_n=block[1], **kw)
    jdx = _lif_bwd_pallas(jvres, jg, surrogate_alpha=alpha,
                          block_m=block[0], block_n=block[1], **kw)
    ts, tvres = lif_scan.lif_fwd_plain(tx, **kw)
    assert (ts.dtype, tvres.dtype) == (torch.bfloat16, torch.float32)
    np.testing.assert_array_equal(_f(ts), _f(js))
    np.testing.assert_array_equal(tvres.numpy(), np.asarray(jvres))
    tdx = lif_scan.lif_bwd_plain(torch.from_numpy(np.array(jvres)), tg,
                                 surrogate_alpha=alpha, **kw)
    assert tdx.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f(tdx), _f(jdx))
    # the wrappers take the plain versions on CPU tensors
    t, p = shape[0], int(np.prod(shape[1:]))
    np.testing.assert_array_equal(
        _f(lif_scan.lif_fwd(tx.reshape(t, p), **kw)[0]), _f(js).reshape(t, p))
    np.testing.assert_array_equal(
        _f(lif_scan.lif_bwd(tvres.reshape(t, p), tg.reshape(t, p),
                            surrogate_alpha=alpha, **kw)),
        _f(jdx).reshape(t, p))


def test_xla_runs_the_reference_at_the_suites_opt_level():
    """The exact bf16 comparison above holds XLA's CPU backend to the
    TPU kernel's rounding (no FMA contraction), which is this level."""
    assert "--xla_backend_optimization_level=0" in \
        os.environ.get("XLA_FLAGS", "")


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_bf16_fire_under_autograd_gives_bf16_spikes_and_gradients(backend):
    rng = np.random.default_rng(4)
    _, tx = _bf16(rng.normal(0.2, 1.2, (2, 3, 40)).astype(np.float32))
    x = tx.clone().requires_grad_(True)
    with dispatch.use_backend(backend, op="lif_scan"):
        s = dispatch.lif_scan(x)
    (dx,) = torch.autograd.grad(s.float().sum(), x)
    assert s.dtype == dx.dtype == torch.bfloat16
    _, vres = lif_scan.lif_fwd_plain(tx)
    want = lif_scan.lif_bwd_plain(vres, torch.ones_like(tx))
    if backend == "cuda":
        assert torch.equal(dx, want)
    else:   # ref's autograd associates the reset term its own way
        np.testing.assert_allclose(_f(dx), _f(want), rtol=2 ** -7, atol=0)


# -------------------------------------------------------- data substrate
@pytest.mark.parametrize("args", [(0, 0, 0, 4, 16, 512), (3, 1, 7, 2, 33, 128),
                                  (1, 2, 5, 8, 128, 32000)])
def test_lm_batch_matches_repro(args):
    got, want = synthetic.lm_batch(*args), jsynthetic.lm_batch(*args)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def _make(shard, step):
    return synthetic.lm_batch(7, shard, step, 2, 8, 64)


def _take(pipe, n):
    it = iter(pipe)
    try:
        return [next(it) for _ in range(n)]
    finally:
        pipe.stop()


def test_pipeline_prefetch_order_restore_and_reshard_match_repro():
    got = _take(pipeline.ShardedPipeline(_make, 1, 0).start(), 5)
    want = _take(jpipeline.ShardedPipeline(_make, 1, 0).start(), 5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["labels"], _make(0, i)["labels"])

    tp = pipeline.ShardedPipeline(_make, 1, 0, start_step=0)
    jp = jpipeline.ShardedPipeline(_make, 1, 0, start_step=0)
    _take(tp, 3), _take(jp, 3)
    assert tp.state_dict() == jp.state_dict() == \
        {"step": 3, "n_shards": 1, "shard": 0}
    resumed = _take(pipeline.ShardedPipeline.restore(_make, tp.state_dict()),
                    2)
    for i, b in enumerate(resumed):
        np.testing.assert_array_equal(b["tokens"], _make(0, 3 + i)["tokens"])
    # elastic reshard: 4 shards, this host shard 2, resumes at step 3
    tr = pipeline.ShardedPipeline.restore(_make, tp.state_dict(), n_shards=4,
                                          shard=2)
    jr = jpipeline.ShardedPipeline.restore(_make, jp.state_dict(), n_shards=4,
                                           shard=2)
    assert (tr.n_shards, tr.shard, tr.step) == (jr.n_shards, jr.shard,
                                                jr.step) == (4, 2, 3)
    for i, (a, b) in enumerate(zip(_take(tr, 2), _take(jr, 2))):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["tokens"], _make(2, 3 + i)["tokens"])


def test_device_put_batch_makes_int64_indices_on_the_device():
    host = _batch(0) | {"frontend": np.ones((2, 3), np.float32)}
    dev = pipeline.device_put_batch(host, torch.device("cpu"))
    assert dev["tokens"].dtype == dev["labels"].dtype == torch.int64
    assert dev["frontend"].dtype == torch.float32
    np.testing.assert_array_equal(dev["tokens"].numpy(), host["tokens"])


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("n,chunk", [(32, 8), (30, 8), (16, 16)],
                         ids=["divides", "falls-back", "one-chunk"])
def test_chunked_ce_loss_and_gradients_match_jax(n, chunk):
    rng = np.random.default_rng(n + chunk)
    h = rng.normal(0, 1, (2, n, 24)).astype(np.float32)
    w = (0.3 * rng.normal(0, 1, (24, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (2, n)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, -3:] = -1

    def jloss(h, w):
        return jlm.chunked_ce_loss(h, w, jnp.asarray(labels), chunk)
    want, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = tlm.chunked_ce_loss(th, tw, torch.from_numpy(labels).long(), chunk)
    dh, dw = torch.autograd.grad(got, (th, tw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_TOL)
    for a, b in ((dh, jdh), (dw, jdw)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=F32_TOL * np.abs(b).max())
    with torch.no_grad():
        assert tlm.chunked_ce_loss(th, tw, torch.from_numpy(labels),
                                   chunk).item() == got.item()


def _fires(monkeypatch):
    """Record every fire's spikes in both packages (the JAX forward runs
    with jit off, so its values are concrete)."""
    got, want = [], []
    t_orig, j_orig = dispatch.dispatch, jdispatch.dispatch

    def trec(op, *a, **k):
        out = t_orig(op, *a, **k)
        if op == "lif_scan":
            got.append(_f(out))
        return out

    def jrec(op, *a, **k):
        out = j_orig(op, *a, **k)
        if op == "lif_scan":
            want.append(_f(out))
        return out
    monkeypatch.setattr(dispatch, "dispatch", trec)
    monkeypatch.setattr(jdispatch, "dispatch", jrec)
    return got, want


@pytest.mark.parametrize("spiking", [True, False], ids=["spiking", "dense"])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_loss_fn_and_every_gradient_leaf_match_jax(trees, spiking, backend,
                                                   monkeypatch):
    tag, jp, fresh = trees
    host = _batch(0)
    want, jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(CFG, p, _jbatch(host), spiking))(jp)
    tp = fresh()
    leaves = adamw.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    got_spikes, want_spikes = _fires(monkeypatch)
    with dispatch.use_backend(backend):
        got = tlm.loss_fn(TCFG, tp, _tbatch(host), spiking)
    grads = torch.autograd.grad(got, leaves)
    with jax.disable_jit():
        jlm.forward_hidden(CFG, jp, jnp.asarray(host["tokens"]), spiking)
    assert len(got_spikes) == len(want_spikes) == (12 if spiking else 0)
    if tag == "f32":
        for a, b in zip(got_spikes, want_spikes):
            np.testing.assert_array_equal(a, b)
    tol = F32_TOL if tag == "f32" else BF16_TOL
    np.testing.assert_allclose(got.item(), float(want), rtol=tol)
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(grads)
    for i, (a, b) in enumerate(zip(grads, jl)):
        assert a.dtype == leaves[i].dtype
        b = _f(b)
        err = np.abs(_f(a) - b).max()
        bound = (F32_TOL * np.abs(b).max() + 1e-7 if tag == "f32"
                 else BF16_TOL * np.abs(b).max())
        assert err <= bound, f"leaf {i} {b.shape}: {err} > {bound}"


def test_loss_fn_refuses_pure_fsdp_and_frontend_labels():
    """pure_fsdp waits for the mesh (item 8). Frontend positions are ported
    since the VLM: they get label -1, so the loss is the mean over the
    token positions alone, as the reference's."""
    tp = tlm.init_params(TCFG, device="cpu")
    b = _tbatch(_batch(0))
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tlm.loss_fn(TCFG.replace(pure_fsdp=True), tp, b, True)
    cfg = TCFG.replace(n_frontend_tokens=4)
    tp["frontend_proj"] = torch.eye(TCFG.d_model, dtype=torch.bfloat16)
    fe = torch.randn(2, 4, TCFG.d_model,
                     generator=torch.Generator().manual_seed(0))
    got = tlm.loss_fn(cfg, tp, b | {"frontend": fe}, True)
    hidden = tlm.forward_hidden(cfg, tp, b["tokens"], True, frontend=fe)
    labels = torch.cat([torch.full((2, 4), -1), b["labels"]], dim=1)
    want = tlm.chunked_ce_loss(hidden, tp["lm_head"], labels, cfg.loss_chunk)
    assert torch.equal(got, want)
    jcfg = CFG.replace(n_frontend_tokens=4)
    jp = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tp)
    jwant = jlm.loss_fn(jcfg, jp, _jbatch(_batch(0)) | {
        "frontend": jnp.asarray(fe.numpy())}, True)
    np.testing.assert_allclose(got.item(), float(jwant), rtol=BF16_TOL)


# ----------------------------------------------------------------- remat
def _count_calls(monkeypatch):
    counts = {"lif_fwd": 0, "lif_bwd": 0, "lif": 0, "causal_sdsa_or": 0}
    for mod, name in ((lif_scan, "lif_fwd"), (lif_scan, "lif_bwd"),
                      (lif_scan, "lif"), (ops, "causal_sdsa_or")):
        orig = getattr(mod, name)

        def rec(*a, _orig=orig, _name=name, **k):
            counts[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, rec)
    return counts


@pytest.mark.parametrize("spiking", [True, False], ids=["spiking", "dense"])
def test_remat_none_full_dots_give_the_same_loss_and_grads(spiking,
                                                           monkeypatch):
    """Bit for bit, in bf16; under "full" and "dots" the forward's fires
    and causal SDSA run again in the backward (the fires' residual
    wrapper twice, the surrogate once; no primal fire)."""
    counts = _count_calls(monkeypatch)
    host = _batch(1)
    runs = {}
    for remat in ("none", "full", "dots"):
        cfg = TCFG.replace(remat=remat)
        tp = tlm.init_params(cfg, seed=3, device="cpu")
        leaves = adamw.leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        for k in counts:
            counts[k] = 0
        with dispatch.use_backend("cuda"):
            loss = tlm.loss_fn(cfg, tp, _tbatch(host), spiking)
            grads = torch.autograd.grad(loss, leaves)
        runs[remat] = (loss, grads, dict(counts))
    fires = 6 * TCFG.n_layers
    for remat, (loss, grads, n) in runs.items():
        assert torch.equal(loss, runs["none"][0]), remat
        for a, b in zip(grads, runs["none"][1]):
            assert torch.equal(a, b), remat
        again = 1 if remat == "none" else 2
        want = ({"lif_fwd": fires * again, "lif_bwd": fires, "lif": 0,
                 "causal_sdsa_or": TCFG.n_layers * again} if spiking
                else dict.fromkeys(n, 0))
        assert n == want, (remat, n)


@pytest.mark.parametrize("shape", [(2, 2, 3, 12, 40), (2, 1, 2, 37, 8),
                                   (2, 1, 1, 64, 16)])
@pytest.mark.parametrize("backend", ["ref", "jnp", "cuda"])
def test_causal_sdsa_gradient_splits_ties_as_jax(shape, backend):
    """`jax.lax.cummax` differentiates as a parallel prefix scan of
    `lax.max`, halving a tie's cotangent at every combine; every backend's
    backward gives that, exactly, on binary spikes with many ties."""
    rng = np.random.default_rng(sum(shape))
    q, k, v = ((rng.random(shape) < 0.4).astype(np.float32)
               for _ in range(3))
    g = rng.normal(size=shape).astype(np.float32)
    _, pull = jax.vjp(jdispatch.causal_sdsa, *map(jnp.asarray, (q, k, v)))
    want = pull(jnp.asarray(g))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with dispatch.use_backend(backend, op="causal_sdsa"):
        out = dispatch.causal_sdsa(*t)
    got = torch.autograd.grad(out, t, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------- grad compression
def _grad_tree(rng):
    def f(*shape, dtype=np.float32):
        return (rng.normal(0, 1e-2, shape)).astype(dtype)
    return {"a": f(8, 16), "b": [f(5), f(3, 4)], "c": {"d": f(7)}}


def test_grad_compress_round_trip_and_error_feedback_match_jax():
    rng = np.random.default_rng(0)
    jg = jax.tree.map(jnp.asarray, _grad_tree(rng))
    tg = params_from_numpy(_np(jg), device="cpu")
    jef, tef = jgc.init(jg), grad_compress.init(tg)
    for _ in range(3):       # the error feedback carries across steps
        jw, js, jef = jgc.compress(jg, jef)
        tw, ts, tef = grad_compress.compress(tg, tef)
        for a, b in zip(adamw.leaves(tw), jax.tree_util.tree_leaves(jw)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(_f(a), _f(b))
            assert np.abs(_f(a)).max() <= 127
        for a, b in zip(adamw.leaves(ts), jax.tree_util.tree_leaves(js)):
            np.testing.assert_allclose(a.item(), float(b), rtol=2 ** -23)
        for a, b in zip(adamw.leaves(tef.error),
                        jax.tree_util.tree_leaves(jef.error)):
            np.testing.assert_array_equal(_f(a), _f(b))
        back = grad_compress.decompress(tw, ts)
        jback = jgc.decompress(jw, js)
        for a, b in zip(adamw.leaves(back), jax.tree_util.tree_leaves(jback)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ------------------------------------------------------------ train step
def _jax_steps(cfg, jp, n, ef=False):
    opt_cfg = jadamw.AdamWConfig(lr=LR, state_dtype=cfg.opt_state_dtype)
    step = jax.jit(jsteps.make_train_step(cfg, opt_cfg, spiking=True,
                                          grad_compression=ef))
    opt = jadamw.init(jp, opt_cfg)
    state = (jp, opt) + ((jgc.init(jp),) if ef else ())
    losses = []
    for i in range(n):
        *state, metrics = step(*state, _jbatch(_batch(i, b=4)))
        losses.append(float(metrics["loss"]))
    return losses, state[0]


def _port_steps(cfg, params, n, ef=False):
    opt_cfg = adamw.AdamWConfig(lr=LR, state_dtype=cfg.opt_state_dtype)
    step = tsteps.make_train_step(cfg, opt_cfg, spiking=True,
                                  grad_compression=ef)
    state = [params, adamw.init(params, opt_cfg)] + \
        ([grad_compress.init(params)] if ef else [])
    losses, norms = [], []
    for i in range(n):
        *state, metrics = step(*state, _tbatch(_batch(i, b=4)))
        assert metrics["loss"].device == metrics["grad_norm"].device
        assert not metrics["loss"].requires_grad
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    assert state[1].step.item() == n
    return losses, state[0], norms


@pytest.mark.parametrize("variant", ["plain", "microbatches", "compressed"])
def test_make_train_step_three_steps_match_jax(variant):
    """f32-cast trees: 3 steps of the jitted reference step against the
    port's, losses and params (tolerances in the module doc)."""
    jcfg, tcfg = CFG, TCFG
    if variant == "microbatches":
        jcfg, tcfg = CFG.replace(microbatches=2), TCFG.replace(microbatches=2)
    ef = variant == "compressed"
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jlm.init_params(CFG, jax.random.PRNGKey(1)))
    want, jfinal = _jax_steps(jcfg, jp, 3, ef)
    params = params_from_numpy(_np(jp), device="cpu")
    got, final, norms = _port_steps(tcfg, params, 3, ef)
    np.testing.assert_allclose(got, want, rtol=F32_TOL)
    assert all(np.isfinite(norms))
    assert adamw.leaves(final)[0] is adamw.leaves(params)[0]   # in place
    for a, b in zip(adamw.leaves(final), jax.tree_util.tree_leaves(jfinal)):
        np.testing.assert_allclose(_f(a), _f(b), rtol=0, atol=STEP_PARAM_TOL)


def test_microbatches_accumulate_in_f32_and_average():
    """m = 2 on a batch of 4 is the mean of the two halves' losses, and
    its gradient the mean of theirs (f32)."""
    params = tlm.init_params(TCFG, seed=5, device="cpu")
    host = _batch(0, b=4)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in host.items()}
              for i in range(2)]
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    per = []
    for h in halves:
        loss = tlm.loss_fn(TCFG, params, _tbatch(h), True)
        per.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    step = tsteps.make_train_step(TCFG.replace(microbatches=2),
                                  adamw.AdamWConfig(lr=0.0))
    _, _, metrics = step(params, adamw.init(params), _tbatch(host))
    assert torch.equal(metrics["loss"], (per[0][0] + per[1][0]) / 2)
    want = [(a.float() + b.float()) / 2 for a, b in zip(per[0][1], per[1][1])]
    assert torch.equal(metrics["grad_norm"], adamw.global_norm(want))


def test_make_train_step_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tsteps.make_train_step(TCFG, mesh=object())


# ------------------------------------------------------------- the loop
def test_train_loop_loss_decreases():
    out = ttrain.train_loop(TINY, steps=25, batch=8, seq=32, lr=3e-3,
                            log_every=100, device="cpu")
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first - 0.1, (first, last)


def test_train_loop_resume_trains_only_the_remaining_steps(tmp_path):
    d = str(tmp_path / "ck")
    ttrain.train_loop(TINY, steps=6, batch=2, seq=16, ckpt_dir=d,
                      save_every=3, log_every=100, device="cpu")
    out = ttrain.train_loop(TINY, steps=9, batch=2, seq=16, ckpt_dir=d,
                            save_every=3, resume=True, log_every=100,
                            device="cpu")
    assert len(out["losses"]) == 3
    assert out["opt_state"].step.item() == 9


def test_resume_past_a_deleted_checkpoint_reproduces_the_losses(tmp_path):
    """6 steps saving every 2 (checkpoints 2, 4, 6); the newest deleted, a
    resumed run from step 4 gives the uninterrupted losses of steps 4-5
    bit for bit, on the kernel path."""
    import shutil
    d = str(tmp_path / "ck")
    kw = dict(steps=6, batch=2, seq=16, ckpt_dir=d, save_every=2,
              log_every=100, device="cpu")
    with dispatch.use_backend("cuda"):
        full = ttrain.train_loop(TCFG, **kw)
        assert sorted(os.listdir(d)) == ["step_000000002", "step_000000004",
                                         "step_000000006"]
        shutil.rmtree(os.path.join(d, "step_000000006"))
        resumed = ttrain.train_loop(TCFG, resume=True, **kw)
    assert resumed["losses"] == full["losses"][4:]
    for a, b in zip(adamw.leaves(resumed["params"]),
                    adamw.leaves(full["params"])):
        assert torch.equal(a, b)


def test_train_loop_refuses_a_mesh_and_a_missing_card():
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        ttrain.train_loop(TINY, steps=1, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.train_loop(TINY, steps=1)


def test_cli_trains_on_the_cpu_and_refuses_cuda_without_a_card(
        monkeypatch, capsys):
    argv = ["train", "--arch", ARCH, "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "16"]
    monkeypatch.setattr("sys.argv", argv + ["--device", "cpu"])
    ttrain.main()
    out = capsys.readouterr().out
    assert "[train] step     0 loss" in out and "[train] done" in out
    if not torch.cuda.is_available():
        monkeypatch.setattr("sys.argv", argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main()


def test_config_fields_the_step_reads_match_repro():
    for name in ("remat", "microbatches", "opt_state_dtype", "loss_chunk",
                 "pure_fsdp", "n_frontend_tokens"):
        assert getattr(TCFG, name) == getattr(CFG, name)
    assert dataclasses.asdict(TINY) == dataclasses.asdict(JTINY)
