"""The spiking LM serving path (TinyLlama-1.1B, reduced) in repro_torch
against the JAX package, on the CPU.

The reduced config (`get_reduced("tinyllama-1.1b")`: 2 layers, d 64, 4
heads, 2 KV heads, vocab 512, T=2) and the same params, moved through
`params_from_numpy`, go into both packages with the same tokens (numpy,
from a seed). The port runs its `ref` oracles (the CPU default) and its
kernel path (`use_backend("cuda")`: the kernel wrappers' plain versions
on CPU tensors).

Tolerances:
  * causal SDSA, the causal-status words, LIF spikes and decode statuses:
    exact;
  * f32 (both param trees cast to float32, so both streams run in f32):
    hidden states and logits within 1e-5 of max|ref|, every spike exact;
  * bf16 (the config's dtypes): BF16_TOL of max|ref|. XLA and oneDNN
    accumulate a bf16 matmul in f32 in different orders before rounding
    to 8 mantissa bits, so an output can land one bf16 ulp (2^-8
    relative) apart and a drive sitting at the threshold can flip a
    spike, which moves one row of the next drive by a weight row.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import sdsa as jsdsa
from repro.kernels import dispatch as jdispatch
from repro.kernels.lif_scan import lif_scan_pallas
from repro.kernels.sdsa_kernel import sdsa_causal_status_pallas
from repro.core.lif import LIFConfig as JLIF
from repro.models import lm as jlm
from repro.models import transformer as jtfm
from repro.models.layers import lif_fire as jfire, rmsnorm as jnorm
from repro_torch.configs import registry as treg
from repro_torch.core import sdsa as tsdsa
from repro_torch.core.lif import LIFConfig
from repro_torch.data.synthetic import markov_tokens
from repro_torch.kernels import dispatch, lif_scan, ops, sdsa_kernel
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import lif_fire, params_from_numpy, rmsnorm

torch.set_num_threads(2)
ARCH = "tinyllama-1.1b"
F32_TOL = 1e-5
BF16_TOL = 2e-2
CFG = jreg.get_reduced(ARCH)
TCFG = treg.get_reduced(ARCH)
N_SLOTS = 4          # == n_heads: the collision the slot contract guards


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_params(CFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=["f32", "bf16"])
def trees(request, jparams):
    """(dtype tag, repro params, port params): the f32 case casts both
    trees to float32, so both streams run in f32."""
    jp = jparams
    if request.param == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return request.param, jp, params_from_numpy(_np(jp), device="cpu")


def _tol(tag, ref):
    return (F32_TOL if tag == "f32" else BF16_TOL) * float(np.abs(ref).max())


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _tokens(batch, seq, seed=0):
    return markov_tokens(seed, 0, 0, batch, seq, CFG.vocab)[:, :seq]


# ---------------------------------------------------------------- configs
def test_configs_registry_and_data_match_repro():
    import dataclasses
    from repro.data.synthetic import markov_tokens as jmarkov
    assert dataclasses.asdict(treg.get_config(ARCH)) == \
        dataclasses.asdict(jreg.get_config(ARCH))
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(CFG)
    assert treg.ARCH_IDS == jreg.ARCH_IDS and ARCH in treg.ARCH_IDS
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert dataclasses.asdict(treg.get_shape(name)) == \
            dataclasses.asdict(jreg.get_shape(name))
    assert dataclasses.asdict(treg.get_config("qwen3-4b")) == \
        dataclasses.asdict(jreg.get_config("qwen3-4b"))
    assert tlm.param_count(treg.get_config(ARCH)) == \
        jlm.param_count(jreg.get_config(ARCH))
    np.testing.assert_array_equal(markov_tokens(3, 1, 2, 4, 40, 512),
                                  jmarkov(3, 1, 2, 4, 40, 512))


def test_unported_configs_and_modes_raise_with_their_roadmap_items():
    """Every config's layer pattern builds as the reference's: the
    attention family, jamba's Mamba / attention hybrid and xLSTM's mLSTM /
    sLSTM blocks (full and reduced). What is still unported raises naming
    its ROADMAP item: `pure_fsdp`'s per-layer gather of a sharded mesh
    (item 8)."""
    pattern, n = tlm.layer_pattern(treg.get_reduced("qwen2-moe-a2.7b"))
    assert [tuple(b) for b in pattern] == [("attn", "moe")] and n == 2
    for arch in ("jamba-1.5-large-398b", "xlstm-350m"):
        for get in ("get_config", "get_reduced"):
            tpat, tn = tlm.layer_pattern(getattr(treg, get)(arch))
            jpat, jn = jlm.layer_pattern(getattr(jreg, get)(arch))
            assert [tuple(b) for b in tpat] == [tuple(b) for b in jpat]
            assert tn == jn
    full, _ = tlm.layer_pattern(treg.get_config("xlstm-350m"))
    assert [b.kind for b in full] == ["mlstm"] * 7 + ["slstm"]
    assert {b.ffn for b in full} == {"none"}
    full, _ = tlm.layer_pattern(treg.get_config("jamba-1.5-large-398b"))
    assert [b.kind for b in full] == ["mamba"] * 3 + ["attn"] + \
        ["mamba"] * 4
    assert [b.ffn for b in full] == ["moe", "mlp"] * 4
    cfg = TCFG.replace(pure_fsdp=True)
    tp = tlm.init_params(TCFG, seed=0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match=r"queue 1 item 8"):
        tlm.loss_fn(cfg, tp, {"tokens": toks, "labels": toks}, True)


def test_init_params_defaults_to_cuda_and_matches_repro_tree(jparams):
    assert inspect.signature(tlm.init_params).parameters["device"] \
        .default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tlm.init_params(TCFG)
    tp = tlm.init_params(TCFG, seed=0, device="cpu")
    jl, jt = jax.tree_util.tree_flatten(jparams)
    tl, tt = jax.tree_util.tree_flatten(tp)
    assert jt == tt
    assert [(tuple(a.shape), str(a.dtype)) for a in jl] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tl]


# -------------------------------------------------------------- causal SDSA
def _spikes(rng, shape, p=0.4):
    return (rng.random(shape) < p).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 2, 3, 12, 40), (2, 1, 2, 100, 64),
                                   (2, 2, 1, 257, 16), (1, 1, 1, 9, 70)])
def test_causal_sdsa_every_backend_matches_jax_exactly(shape):
    rng = np.random.default_rng(sum(shape))
    q, k, v = (_spikes(rng, shape) for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jsdsa.causal_sdsa_jnp(jq, jk, jv))
    with jdispatch.use_backend("pallas-interpret", op="causal_sdsa"):
        np.testing.assert_array_equal(
            np.asarray(jdispatch.causal_sdsa(jq, jk, jv)), want)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for name in ("ref", "jnp", "cuda"):
        with dispatch.use_backend(name, op="causal_sdsa"):
            assert dispatch.resolve_attribution("causal_sdsa", *t) == name
            np.testing.assert_array_equal(dispatch.causal_sdsa(*t).numpy(),
                                          want, err_msg=name)
    np.testing.assert_array_equal(
        tsdsa.causal_sdsa_jnp(*t, mode="sum").numpy(),
        np.asarray(jsdsa.causal_sdsa_jnp(jq, jk, jv, mode="sum")))
    assert dispatch.resolve("causal_sdsa", *t).name == "ref"   # CPU default


def test_causal_sdsa_sum_mode_degrades_and_bf16_stays_bf16():
    rng = np.random.default_rng(5)
    t = [torch.from_numpy(_spikes(rng, (2, 1, 2, 10, 24))) for _ in range(3)]
    dispatch.reset_fallback_warnings()
    with dispatch.use_backend("cuda", op="causal_sdsa"), \
            pytest.warns(RuntimeWarning, match="mode='or'"):
        got = dispatch.causal_sdsa(*t, mode="sum")
    assert torch.equal(got, tsdsa.causal_sdsa_jnp(*t, mode="sum"))
    b = [x.bfloat16() for x in t]
    out = ops.causal_sdsa_or(*b)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), tsdsa.causal_sdsa_jnp(*t))


def test_causal_sdsa_equals_streaming_decode():
    """The prefix-OR op == folding `sdsa_decode_update` token by token."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(_spikes(rng, (2, 2, 10, 24)))
               for _ in range(3))
    full = ops.causal_sdsa_or(q, k, v)
    status = tsdsa.sdsa_decode_init((2, 24), device="cpu")
    for i in range(10):
        phase = (k[:, :, i] * v[:, :, i]).amax(dim=0)
        status = tsdsa.sdsa_decode_update(status, phase,
                                          torch.ones_like(phase))
        assert torch.equal(full[:, :, i],
                           tsdsa.sdsa_decode_attend(q[:, :, i], status[None]))


@pytest.mark.parametrize("bh,n,dw,block_n", [(3, 64, 2, 64), (2, 512, 1, 128),
                                             (4, 256, 3, 32)])
def test_causal_status_plain_matches_the_pallas_kernel(bh, n, dw, block_n):
    rng = np.random.default_rng(n + dw)
    words = rng.integers(0, 2 ** 32, (bh, n, dw), dtype=np.uint64)
    words &= rng.integers(0, 2 ** 32, (bh, n, dw), dtype=np.uint64)
    words &= rng.integers(0, 2 ** 32, (bh, n, dw), dtype=np.uint64)
    words = words.astype(np.uint32)
    want = np.asarray(sdsa_causal_status_pallas(jnp.asarray(words),
                                                block_n=block_n,
                                                interpret=True))
    tw = torch.from_numpy(words.view(np.int32)).view(torch.uint32)
    got = sdsa_kernel.sdsa_causal_status(tw)
    np.testing.assert_array_equal(got.view(torch.int32).numpy().view(
        np.uint32), want)
    np.testing.assert_array_equal(want, np.bitwise_or.accumulate(words, 1))


@pytest.mark.parametrize("n", [1, 31, 1000])
def test_causal_status_plain_takes_any_token_count(n):
    words = np.random.default_rng(n).integers(
        0, 2 ** 32, (2, n, 2), dtype=np.uint64).astype(np.uint32)
    words[:, 1::2] = 0
    tw = torch.from_numpy(words.view(np.int32)).view(torch.uint32)
    got = sdsa_kernel.sdsa_causal_status_plain(tw)
    np.testing.assert_array_equal(got.view(torch.int32).numpy().view(
        np.uint32), np.bitwise_or.accumulate(words, 1))
    with pytest.raises(ValueError, match="uint32"):
        sdsa_kernel.sdsa_causal_status(tw.view(torch.int32))


# -------------------------------------------------------------- LIF bf16
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_lif_on_bf16_drives_matches_the_jax_kernel(backend):
    """bf16 in, bf16 spikes out, f32 membrane: equal to `repro`'s
    `lif_scan_pallas` on the same bf16 drive, including drives that land
    exactly on the threshold."""
    rng = np.random.default_rng(2)
    x = rng.normal(0.6, 0.8, (2, 8, 256)).astype(np.float32)
    x[0, 0, :8] = [1.0, 0.5, 2.0, 0.99609375, 1.0078125, 0, -1, 1.5]
    x[1, 0, :8] = [0.5, 0.75, -1, 1.0, 0.25, 1.0, 0.5, 0.25]
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = _f(lif_scan_pallas(jx, interpret=True))
    tx = torch.from_numpy(_f(jx)).bfloat16()
    with dispatch.use_backend(backend, op="lif_scan"):
        got = dispatch.lif_scan(tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f(got), want)
    np.testing.assert_array_equal(_f(lif_scan.lif_plain(tx.reshape(2, -1))),
                                  want.reshape(2, -1))
    np.testing.assert_array_equal(_f(jdispatch.dispatch("lif_scan", jx)),
                                  want)


# ------------------------------------------------------------- attention
def _attn_case(seed, causal_shape=(2, 2, 12)):
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jtfm.attn_init(
        jax.random.PRNGKey(seed), CFG.d_model, CFG.n_heads, CFG.n_kv_heads,
        CFG.head_dim))
    s = _spikes(rng, causal_shape + (CFG.d_model,), 0.3)
    return jp, params_from_numpy(_np(jp), device="cpu"), s


KW = dict(n_heads=CFG.n_heads, n_kv=CFG.n_kv_heads, d_head=CFG.head_dim)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_attention_sdsa_matches_jax(causal, backend):
    jp, tp, s = _attn_case(11)
    want = np.asarray(jtfm.attention_sdsa(jp, jnp.asarray(s), lif_cfg=JLIF(),
                                          causal=causal, **KW))
    with dispatch.use_backend(backend):
        got = ttfm.attention_sdsa(tp, torch.from_numpy(s), lif_cfg=LIFConfig(),
                                  causal=causal, **KW)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                               atol=F32_TOL * np.abs(want).max())


def test_repeat_kv_repeats_heads_in_place():
    k = torch.arange(6.0).reshape(1, 3, 2)
    np.testing.assert_array_equal(
        ttfm._repeat_kv(k, 2).numpy(),
        np.asarray(jtfm._repeat_kv(jnp.asarray(k.numpy()), 2)))


def test_attention_sdsa_decode_matches_jax_and_the_full_sequence():
    """Token-by-token decode against repro's, and its outputs against the
    full-sequence causal attention's rows."""
    jp, tp, s = _attn_case(12, (2, 2, 6))
    jst = jtfm.sdsa_state_init(2, CFG.n_heads, CFG.head_dim)
    tst = ttfm.sdsa_state_init(2, CFG.n_heads, CFG.head_dim, device="cpu")
    full = ttfm.attention_sdsa(tp, torch.from_numpy(s), lif_cfg=LIFConfig(),
                               **KW)
    for i in range(6):
        jo, jst = jtfm.attention_sdsa_decode(
            jp, jnp.asarray(s[:, :, i]), jst, lif_cfg=JLIF(), **KW)
        to, tst = ttfm.attention_sdsa_decode(
            tp, torch.from_numpy(s[:, :, i]), tst, lif_cfg=LIFConfig(), **KW)
        np.testing.assert_array_equal(_f(tst.status), _f(jst.status))
        assert tst.status.dtype == torch.bfloat16
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=F32_TOL,
                                   atol=F32_TOL * np.abs(jo).max())
        np.testing.assert_allclose(to.numpy(), full[:, :, i].numpy(),
                                   rtol=F32_TOL, atol=F32_TOL)


# ------------------------------------------------------------ whole model
def test_blocks_match_jax_layer_by_layer(trees):
    """Each block on the same input stream: its ln1 fire exactly, its
    output within the dtype's tolerance."""
    tag, jp, tp = trees
    jpat, n_groups = jlm.layer_pattern(CFG)
    tpat, tn = tlm.layer_pattern(TCFG)
    assert (len(jpat), n_groups) == (len(tpat), tn)
    toks = _tokens(2, 16)
    jx = jnp.take(jp["embed"], jnp.asarray(toks), axis=0)
    jx = jnp.broadcast_to(jx[None], (2,) + jx.shape)
    lif = jlm.lif_cfg_of(CFG)
    for g in range(n_groups):
        jg = jax.tree.map(lambda a: a[g], jp["blocks"][0])
        tg = tlm._group(tp["blocks"][0], g)
        tx = torch.from_numpy(_f(jx)).to(tp["embed"].dtype)
        np.testing.assert_array_equal(
            _f(lif_fire(rmsnorm(tg["ln1"], tx), tlm.lif_cfg_of(TCFG))),
            _f(jfire(jnorm(jg["ln1"], jx), lif)))
        want = jlm._apply_block(CFG, jpat[0], jg, jx, True)
        got = tlm._apply_block(TCFG, tpat[0], tg, tx, True)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(_f(got), _f(want),
                                   atol=_tol(tag, _f(want)), rtol=0)
        jx = want


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_prefill_and_forward_hidden_match_jax(trees, backend):
    tag, jp, tp = trees
    toks = _tokens(2, 16, seed=1)
    jt = jnp.asarray(toks)
    want_h = _f(jlm.forward_hidden(CFG, jp, jt, True))
    want = _f(jlm.prefill(CFG, jp, jt, True))
    with torch.inference_mode(), dispatch.use_backend(backend):
        got_h = tlm.forward_hidden(TCFG, tp, torch.from_numpy(toks).long(),
                                   True)
        got = tlm.prefill(TCFG, tp, torch.from_numpy(toks).long(), True)
    assert got.dtype == torch.float32 and got_h.dtype == tp["embed"].dtype
    np.testing.assert_allclose(_f(got_h), want_h, rtol=0,
                               atol=_tol(tag, want_h))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_tol(tag, want))


def _state_arrays(state):
    return [_f(st.sdsa.status) for st in state]


def test_decode_steps_match_jax_logits_and_state(trees):
    tag, jp, tp = trees
    toks = _tokens(3, 5, seed=2)
    jst = jlm.init_decode_state(CFG, 3, 8, True)
    tst = tlm.init_decode_state(TCFG, 3, 8, True, device="cpu")
    assert [tuple(s.sdsa.status.shape) for s in tst] == \
        [tuple(s.sdsa.status.shape) for s in jst]
    for i in range(toks.shape[1]):
        jl, jst = jlm.decode_step(CFG, jp, jst, jnp.asarray(toks[:, i]),
                                  jnp.int32(i), True)
        with torch.inference_mode(), dispatch.use_backend("cuda"):
            tl, tst = tlm.decode_step(TCFG, tp, tst,
                                      torch.from_numpy(toks[:, i]).long(), i,
                                      True)
        np.testing.assert_allclose(tl.numpy(), _f(jl), rtol=0,
                                   atol=_tol(tag, _f(jl)))
        for a, b in zip(_state_arrays(tst), _state_arrays(jst)):
            np.testing.assert_array_equal(a, b)


def test_prefill_chunked_with_ragged_lengths_matches_jax(trees):
    """Right-padded prompts of lengths (5, 8, 3): the last live logits and
    the statuses equal repro's, and each slot's status equals its prompt
    run alone, bit for bit (a pad token leaves the status unchanged); the
    solo logits agree within the dtype's tolerance (a batch of 1 sums its
    matmuls in another blocking)."""
    tag, jp, tp = trees
    toks = _tokens(3, 8, seed=3)
    lengths = np.array([5, 8, 3], np.int32)
    jl, jst = jlm.prefill_chunked(CFG, jp, jnp.asarray(toks),
                                  jnp.asarray(lengths), True, 16)
    with torch.inference_mode():
        tl, tst = tlm.prefill_chunked(TCFG, tp, torch.from_numpy(toks).long(),
                                      torch.from_numpy(lengths), True, 16)
    np.testing.assert_allclose(tl.numpy(), _f(jl), rtol=0,
                               atol=_tol(tag, _f(jl)))
    for a, b in zip(_state_arrays(tst), _state_arrays(jst)):
        np.testing.assert_array_equal(a, b)
    for slot, n in enumerate(lengths):
        with torch.inference_mode():
            sl, solo = tlm.prefill_chunked(
                TCFG, tp, torch.from_numpy(toks[slot:slot + 1, :n]).long(),
                torch.tensor([n]), True, 16)
        np.testing.assert_allclose(sl[0].numpy(), tl[slot].numpy(), rtol=0,
                                   atol=_tol(tag, tl.numpy()))
        for a, b in zip(solo, tst):
            assert torch.equal(a.sdsa.status[:, 0], b.sdsa.status[:, slot])


def test_prefill_agrees_with_prefill_chunked(trees):
    """Equal-length prompts: the full-sequence prefill (causal prefix-OR
    over N rows) and the streaming prefill (one row at a time) give the
    same last-position logits within the dtype's tolerance."""
    tag, _, tp = trees
    toks = torch.from_numpy(_tokens(2, 10, seed=4)).long()
    with torch.inference_mode(), dispatch.use_backend("cuda"):
        full = tlm.prefill(TCFG, tp, toks, True)
        streamed, _ = tlm.prefill_chunked(TCFG, tp, toks,
                                          torch.tensor([10, 10]), True, 16)
        with_state, _ = tlm.prefill_with_state(TCFG, tp, toks, True)
    np.testing.assert_allclose(streamed.numpy(), full.numpy(), rtol=0,
                               atol=_tol(tag, full.numpy()))
    assert torch.equal(with_state, streamed)


# --------------------------------------------------------------- serving
def _greedy(tp, state, token, pos, steps):
    out = []
    for _ in range(steps):
        logits, state = tlm.decode_step(TCFG, tp, state, token, pos, True)
        token = logits.argmax(-1)
        pos = pos + 1
        out.append(token)
    return torch.stack(out, 1), state


def test_per_slot_decode_equals_solo_decode(trees):
    """Staggered admission into a 4-slot pool (4 heads: the dimension
    collision the slot contract guards): every request generates the
    tokens it generates alone."""
    _, _, tp = trees
    rng = np.random.default_rng(0)
    prompts = [torch.from_numpy(rng.integers(0, CFG.vocab, n)).long()
               for n in (5, 9, 7)]
    max_new = 6
    with torch.inference_mode():
        solo = []
        for p in prompts:
            logits, st = tlm.prefill_chunked(TCFG, tp, p[None],
                                             torch.tensor([len(p)]), True, 64)
            toks, _ = _greedy(tp, st, logits.argmax(-1),
                              torch.tensor([len(p)]), max_new - 1)
            solo.append(torch.cat([logits.argmax(-1), toks[0]]).tolist())
        pool = tlm.init_decode_state(TCFG, N_SLOTS, 64, True, device="cpu")
        token = torch.zeros(N_SLOTS, dtype=torch.long)
        pos = torch.zeros(N_SLOTS, dtype=torch.long)
        generated = {}
        admit = {0: 0, 2: 1, 3: 2}          # step -> request
        for step in range(max_new + 4):
            if step in admit:
                r = admit[step]
                p = prompts[r]
                logits, st = tlm.prefill_chunked(
                    TCFG, tp, p[None], torch.tensor([len(p)]), True, 64)
                pool = tlm.merge_slot_state(pool, st, r)
                token[r] = logits.argmax(-1)[0]
                pos[r] = len(p)
                generated[r] = [int(token[r])]
            logits, pool = tlm.decode_step(TCFG, tp, pool, token, pos, True)
            nxt = logits.argmax(-1)
            for r in generated:
                if len(generated[r]) < max_new:
                    generated[r].append(int(nxt[r]))
            token, pos = nxt, pos + 1
    assert [generated[r] for r in range(3)] == solo


def test_reset_slot_state_is_structural():
    state = tlm.init_decode_state(TCFG, N_SLOTS, 8, True, device="cpu")
    state = [tlm.LayerState(sdsa=ttfm.SDSAState(s.sdsa.status + 1))
             for s in state]
    out = tlm.reset_slot_state(state, 2, N_SLOTS)
    st = out[0].sdsa.status
    assert torch.all(st[:, 2] == 0) and torch.all(st[:, [0, 1, 3]] == 1)
    assert torch.all(state[0].sdsa.status == 1)          # input untouched
    bad = [tlm.LayerState(sdsa=ttfm.SDSAState(torch.zeros(N_SLOTS)))]
    with pytest.raises(ValueError, match="not slot-batched"):
        tlm.reset_slot_state(bad, 0, N_SLOTS)
    bad = [tlm.LayerState(sdsa=ttfm.SDSAState(torch.zeros(2, 3, 4)))]
    with pytest.raises(ValueError, match="not slot-batched"):
        tlm.reset_slot_state(bad, 0, N_SLOTS)
