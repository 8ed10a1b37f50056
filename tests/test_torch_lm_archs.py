"""The LM architectures in repro_torch against the JAX package, on the
CPU: qwen2-moe-a2.7b and mixtral-8x22b (MoE FFNs), qwen3-4b (qk-norm,
decoupled head dim), internlm2-20b, mistral-large-123b, phi-3-vision-4.2b
(stub patch embeddings prepended) and whisper-medium (an encoder over
stub frame embeddings, cross-attention in every decoder layer), each at
its `REDUCED` size, and variants of reduced qwen2-moe (MoE on every other
layer, two dispatch groups, the shard-map route); the SSM configs,
xlstm-350m (mLSTM and sLSTM blocks) and jamba-1.5-large-398b (Mamba and
attention, MoE FFNs), reduced, and reduced jamba with MLP FFNs only
("jamba-no-moe").

Params are the reference's `init_params`, moved through
`params_from_numpy`; tokens and frontend embeddings are numpy, from a
seed. Both modes: spiking (SDSA, LIF fires, rate decoding) and dense.
Training and serving are in `tests/test_torch_lm_archs_train.py`.

Tolerances:
  * f32 (both trees cast to float32, the reference compiled as its
    callers run it): hidden states, logits and losses within 1e-5 of
    max|ref|, every gradient leaf within 1e-5 * max|leaf| + 1e-7, the
    spiking decode statuses exact, the dense KV caches (bf16 in both
    packages) within one bf16 rounding (2^-8 of max|ref|). The SSM
    configs' hidden states, logits and f32 recurrent states within 2^-8
    of max|ref| (SSM_F32_TOL): each scan step rounds its output to bf16
    whatever the params' dtype (`repro/models/ssm.py:68`, `:155`, `:241`),
    so a one-ulp f32 difference in a reduction's order can move a whole
    bf16 step, which later layers read (`tests/test_torch_ssm.py`);
  * bf16 (the configs' dtypes): against the reference run op by op
    (`jax.disable_jit()`), spiking bit for bit, dense within BF16_TOL of
    max|ref| (XLA and oneDNN sum a bf16 product's f32 terms in other
    orders, so a value can land one bf16 ulp apart). Compiled, the
    reference drops a rounding the op-by-op run makes: XLA folds the
    bf16 sum `x @ w_gate + x @ w_up` of a spiking MLP into the fire's f32
    convert, so the compiled hidden drive is never rounded to bf16. Over
    qwen2-moe's shared-expert fire, which scans every flattened token as
    a time step, that flips spikes and reroutes tokens (0.79 of max|ref|
    on the reduced model's hidden state), while the op-by-op run and the
    port agree bit for bit;
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MoESpec
from repro_torch.kernels import dispatch
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.layers import params_from_numpy

torch.set_num_threads(2)
F32_TOL = 1e-5
SSM_F32_TOL = 2.0 ** -8
BF16_TOL = 2e-2
ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x22b", "qwen3-4b", "internlm2-20b",
         "mistral-large-123b", "phi-3-vision-4.2b", "whisper-medium")
SSM_ARCHS = ("jamba-1.5-large-398b", "xlstm-350m")
SSM_NAMES = SSM_ARCHS + ("jamba-no-moe",)
_MOE_RED = jreg.get_reduced("qwen2-moe-a2.7b")
# Reduced qwen2-moe variants: MoE on layers 1, 3 (an [mlp, moe] pattern),
# two dispatch groups, the shard-map MoE route (no mesh).
VARIANTS = {
    "moe-every-2": dict(n_layers=4, moe=dict(
        n_experts=8, top_k=2, d_ff_expert=32, n_shared=0, moe_every=2,
        moe_offset=1)),
    "moe-groups-2": dict(moe_dispatch_groups=2),
    "moe-shard-map": dict(moe_shard_map=True),
}


def _cfgs(name):
    """(repro config, port config) of an arch id, a VARIANTS name or
    "jamba-no-moe"."""
    if name == "jamba-no-moe":
        return (jreg.get_reduced(SSM_ARCHS[0]).replace(moe=None),
                treg.get_reduced(SSM_ARCHS[0]).replace(moe=None))
    if name in VARIANTS:
        kw = dict(VARIANTS[name])
        moe = kw.pop("moe", None)
        jc, tc = _MOE_RED.replace(**kw), treg.get_reduced(
            "qwen2-moe-a2.7b").replace(**kw)
        if moe is not None:
            from repro.configs.base import MoESpec as JMoESpec
            jc, tc = jc.replace(moe=JMoESpec(**moe)), tc.replace(
                moe=MoESpec(**moe))
        return jc, tc
    return jreg.get_reduced(name), treg.get_reduced(name)


_PARAMS: dict = {}


def _trees(name, tag):
    """(repro params, port params) for the config `name`, f32 or bf16."""
    key = (name, tag)
    if key not in _PARAMS:
        jc, _ = _cfgs(name)
        jp = jlm.init_params(jc, jax.random.PRNGKey(7))
        if tag == "f32":
            jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        _PARAMS[key] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                              device="cpu"))
    return _PARAMS[key]


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(jc, tag, batch=2, seq=12, seed=0):
    """tokens (B, N) and, where the config has a stub frontend, its
    embeddings (B, F, D): (numpy dict, repro dict, port dict)."""
    rng = np.random.default_rng(seed)
    host = {"tokens": rng.integers(0, jc.vocab, (batch, seq)),
            "labels": rng.integers(0, jc.vocab, (batch, seq))}
    frames = jc.n_frontend_tokens or jc.encoder_seq
    if frames:
        host["frontend"] = rng.standard_normal(
            (batch, frames, jc.d_model)).astype(np.float32)
    dt = (jnp.float32, torch.float32) if tag == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    jb = {k: jnp.asarray(v).astype(dt[0]) if k == "frontend"
          else jnp.asarray(v) for k, v in host.items()}
    tb = {k: torch.from_numpy(v).to(dt[1]) if k == "frontend"
          else torch.from_numpy(v) for k, v in host.items()}
    return host, jb, tb


def _f32_tol(name):
    return SSM_F32_TOL if name in SSM_NAMES else F32_TOL


def _close(got, want, tol):
    got, want = _f(got), _f(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# ---------------------------------------------------------------- configs
def test_registry_matches_repro():
    assert treg.ARCH_IDS == jreg.ARCH_IDS and len(treg.ARCH_IDS) == 10
    for arch in jreg.ARCH_IDS:
        assert dataclasses.asdict(treg.get_config(arch)) == \
            dataclasses.asdict(jreg.get_config(arch))
        assert dataclasses.asdict(treg.get_reduced(arch)) == \
            dataclasses.asdict(jreg.get_reduced(arch))
    assert treg.all_cells() == jreg.all_cells() and \
        len(treg.all_cells()) == 40
    assert treg.PAPER_TRANSFORMERS == jreg.PAPER_TRANSFORMERS
    with pytest.raises(KeyError):
        treg.get_config("gpt-7")


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_param_count_matches_repro(arch):
    """The full and reduced configs' parameter counts (qwen2-moe: 14.32B;
    jamba: 398,553,047,040; xlstm: 222,763,264), from the port's own tree
    on the meta device."""
    cfg = treg.get_config(arch)
    assert tlm.param_count(cfg) == jlm.param_count(jreg.get_config(arch))
    assert tlm.param_count(treg.get_reduced(arch)) == \
        jlm.param_count(jreg.get_reduced(arch))
    if arch in SSM_ARCHS:
        assert tlm.param_count(cfg) == {"jamba-1.5-large-398b":
                                        398_553_047_040,
                                        "xlstm-350m": 222_763_264}[arch]


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_layer_pattern_matches_repro(arch):
    for get in ("get_config", "get_reduced"):
        tc = getattr(treg, get)(arch)
        jpat, jn = jlm.layer_pattern(getattr(jreg, get)(arch))
        tpat, tn = tlm.layer_pattern(tc)
        assert [tuple(s) for s in tpat] == [tuple(s) for s in jpat]
        assert tn == jn


@pytest.mark.parametrize("name", ARCHS + tuple(VARIANTS) + SSM_NAMES)
def test_init_params_tree_matches_repro(name):
    jc, tc = _cfgs(name)
    jp = jax.eval_shape(lambda k: jlm.init_params(jc, k),
                        jax.random.PRNGKey(0))
    tp = tlm.init_params(tc, seed=0, device="cpu")
    jl, jt = jax.tree_util.tree_flatten(jp)
    tl, tt = jax.tree_util.tree_flatten(tp)
    assert jt == tt
    assert [(tuple(a.shape), str(a.dtype)) for a in jl] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tl]


def test_layernorm_matches_repro():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3 + 1
    jp = {"scale": jnp.asarray(rng.standard_normal(48).astype(np.float32)),
          "bias": jnp.asarray(rng.standard_normal(48).astype(np.float32))}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tuple(tlayers.layernorm_init(48, device="cpu")) == \
        tuple(jlayers.layernorm_init(48))
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        want = jlayers.layernorm(jp, jnp.asarray(x).astype(dt))
        got = tlayers.layernorm(tp, torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        _close(got, want, 1e-6 if dt == jnp.float32 else 2.0 ** -8)


# ---------------------------------------------------------- full sequence
@pytest.mark.parametrize("spiking", [True, False], ids=["spiking", "dense"])
@pytest.mark.parametrize("name", ARCHS + tuple(VARIANTS) + SSM_NAMES)
def test_forward_hidden_and_prefill_match_repro(name, spiking):
    """f32 trees: the hidden state (with the VLM's frontend positions) and
    the last-position logits; spiking on the kernels' plain versions
    (`use_backend("cuda")`)."""
    jc, tc = _cfgs(name)
    jp, tp = _trees(name, "f32")
    _, jb, tb = _inputs(jc, "f32")
    fe_j, fe_t = jb.get("frontend"), tb.get("frontend")
    want_h = jlm.forward_hidden(jc, jp, jb["tokens"], spiking, frontend=fe_j)
    want = jlm.prefill(jc, jp, jb["tokens"], spiking, frontend=fe_j)
    with torch.inference_mode(), dispatch.use_backend("cuda"):
        got_h = tlm.forward_hidden(tc, tp, tb["tokens"], spiking,
                                   frontend=fe_t)
        got = tlm.prefill(tc, tp, tb["tokens"], spiking, frontend=fe_t)
    assert got.dtype == torch.float32
    assert got_h.shape[1] == tb["tokens"].shape[1] + jc.n_frontend_tokens
    _close(got_h, want_h, _f32_tol(name))
    _close(got, want, _f32_tol(name))


@pytest.mark.parametrize("spiking", [True, False], ids=["spiking", "dense"])
@pytest.mark.parametrize("arch", ARCHS + SSM_NAMES)
def test_bf16_forward_hidden_matches_repro_op_by_op(arch, spiking):
    jc, tc = _cfgs(arch)
    jp, tp = _trees(arch, "bf16")
    _, jb, tb = _inputs(jc, "bf16", seq=8)
    with jax.disable_jit():
        want = jlm.forward_hidden(jc, jp, jb["tokens"], spiking,
                                  frontend=jb.get("frontend"))
    with torch.inference_mode():
        got = tlm.forward_hidden(tc, tp, tb["tokens"], spiking,
                                 frontend=tb.get("frontend"))
    assert got.dtype == torch.bfloat16
    if spiking:
        np.testing.assert_array_equal(_f(got), _f(want))
    else:
        _close(got, want, BF16_TOL)


def test_encoder_decoder_needs_its_frontend():
    jc, tc = _cfgs("whisper-medium")
    _, tp = _trees("whisper-medium", "f32")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="frontend"):
        tlm.forward_hidden(tc, tp, toks, True)


# ------------------------------------------------------------------ decode
def _state_leaves(state):
    out = []
    for st in state:
        for f in st._fields:
            v = getattr(st, f)
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif v is not None:
                out.extend(v)
    return out


def _jstate_leaves(state):
    out = []
    for st in state:
        for f in st._fields:
            v = getattr(st, f)
            if v is not None:
                out.extend(jax.tree_util.tree_leaves(v))
    return out


def _check_state_leaves(tst, jst, spiking, tol):
    """Every decode-state leaf in the reference's dtype and shape: the
    bf16 ones exact when spiking (SDSA statuses, Mamba's conv window of
    spike drives) and within one bf16 rounding in dense mode (KV caches,
    Mamba's conv window), the f32 ones (the SSM recurrences) within
    `tol` of max|ref|."""
    tleaves, jleaves = _state_leaves(tst), _jstate_leaves(jst)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        assert tuple(a.shape) == b.shape
        if a.dtype == torch.float32:
            _close(a, b, tol)
        elif spiking:
            np.testing.assert_array_equal(_f(a), _f(b))
        else:
            _close(a, b, 2.0 ** -8)


@pytest.mark.parametrize("spiking", [True, False], ids=["spiking", "dense"])
@pytest.mark.parametrize("name", ARCHS + ("moe-every-2",) + SSM_NAMES)
def test_decode_steps_match_repro(name, spiking):
    """Three slots, four steps at per-slot positions; whisper's cross
    state stays the zeros `init_state` makes, as in the reference."""
    jc, tc = _cfgs(name)
    jp, tp = _trees(name, "f32")
    toks = np.random.default_rng(2).integers(0, jc.vocab, (3, 4))
    jst = jlm.init_decode_state(jc, 3, 8, spiking)
    tst = tlm.init_decode_state(tc, 3, 8, spiking, device="cpu")
    for i in range(toks.shape[1]):
        pos = np.array([i, i + 1, i + 2])
        jl, jst = jlm.decode_step(jc, jp, jst, jnp.asarray(toks[:, i]),
                                  jnp.asarray(pos, jnp.int32), spiking)
        with torch.inference_mode(), dispatch.use_backend("cuda"):
            tl, tst = tlm.decode_step(tc, tp, tst,
                                      torch.from_numpy(toks[:, i]),
                                      torch.from_numpy(pos), spiking)
        _close(tl, jl, _f32_tol(name))
        _check_state_leaves(tst, jst, spiking, _f32_tol(name))
    if jc.encoder_decoder:
        cross = [st.cross_status if spiking else st.cross_kv[0]
                 for st in tst]
        assert all(not c.any() for c in cross)


@pytest.mark.parametrize("spiking", [True, False], ids=["spiking", "dense"])
@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "whisper-medium") +
                         SSM_NAMES)
def test_prefill_chunked_with_ragged_lengths_matches_repro(arch, spiking):
    jc, tc = _cfgs(arch)
    jp, tp = _trees(arch, "f32")
    toks = np.random.default_rng(3).integers(0, jc.vocab, (3, 8))
    lengths = np.array([5, 8, 3], np.int32)
    jl, jst = jlm.prefill_chunked(jc, jp, jnp.asarray(toks),
                                  jnp.asarray(lengths), spiking, 16)
    with torch.inference_mode():
        tl, tst = tlm.prefill_chunked(tc, tp, torch.from_numpy(toks),
                                      torch.from_numpy(lengths), spiking, 16)
    _close(tl, jl, _f32_tol(arch))
    _check_state_leaves(tst, jst, spiking, _f32_tol(arch))
