"""Dense GQA, the LM's `spiking=False` baseline, in repro_torch against the
JAX package, on the CPU.

RoPE, `attention_dense` (one block and the blockwise online softmax),
`attention_dense_decode` (scalar and per-slot positions, the one-hot and
the index cache write) and the dense LM's prefill / decode / chunked
prefill, on the same inputs (numpy, from a seed) and the same weights
(moved through `params_from_numpy`).

Tolerances:
  * f32 (the ops, and the LM with both param trees cast to float32):
    within 1e-5 of max|ref|. The KV cache is bf16 in both packages
    whatever the params' dtype, as in the reference;
  * bf16 (the config's dtypes): BF16_TOL of max|ref|, for the reason
    tests/test_torch_lm.py states (XLA and oneDNN round a bf16 matmul's
    f32 sum to 8 mantissa bits after summing in different orders);
  * a pad step of the chunked prefill leaves a slot's KV rows bitwise as
    they were.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import transformer as jtfm
from repro_torch.configs import registry as treg
from repro_torch.data.synthetic import markov_tokens
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import params_from_numpy

torch.set_num_threads(2)
ARCH = "tinyllama-1.1b"
F32_TOL = 1e-5
BF16_TOL = 2e-2
CFG = jreg.get_reduced(ARCH)
TCFG = treg.get_reduced(ARCH)
D, H, KV, DH = 64, 4, 2, 16


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=F32_TOL):
    got, want = _f(got), _f(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _attn_params(seed, qk_norm=False):
    """f32 attention params in both packages; random qk-norm scales."""
    jp = jtfm.attn_init(jax.random.PRNGKey(seed), D, H, KV, DH, qk_norm)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    if qk_norm:
        rng = np.random.default_rng(seed)
        for name in ("q_norm", "k_norm"):
            jp[name] = {"scale": jnp.asarray(
                rng.uniform(0.5, 1.5, DH).astype(np.float32))}
    return jp, params_from_numpy(_np(jp), device="cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


# -------------------------------------------------------------------- RoPE
@pytest.mark.parametrize("d_head,theta", [(16, 1e4), (64, 1e6), (8, 5e5)])
def test_rope_angles_and_apply_rope_match_jax(d_head, theta):
    rng = np.random.default_rng(d_head)
    pos = rng.integers(0, 4096, (3, 7))
    js, jc = jlayers.rope_angles(jnp.asarray(pos), d_head, theta)
    ts, tc = tlayers.rope_angles(torch.from_numpy(pos), d_head, theta)
    assert ts.dtype == tc.dtype == torch.float32
    assert tuple(ts.shape) == (3, 7, d_head // 2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    x = _x(d_head, (3, 7, 4, d_head))
    for dtype, jdt, tol in ((torch.float32, jnp.float32, F32_TOL),
                            (torch.bfloat16, jnp.bfloat16, BF16_TOL)):
        want = jlayers.apply_rope(jnp.asarray(x).astype(jdt), js, jc)
        got = tlayers.apply_rope(torch.from_numpy(x).to(dtype), ts, tc)
        assert got.dtype == dtype
        _close(got, want, tol)


def test_apply_rope_rotates_halves_not_lanes():
    """Lane i pairs with lane i + d/2 (jnp.split's halves)."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 1] = 1.0
    ang = torch.full((1, 1, 4), np.pi / 2)
    out = tlayers.apply_rope(x, torch.sin(ang), torch.cos(ang))
    np.testing.assert_allclose(out.flatten().numpy(),
                               [0, 0, 0, 0, 0, 1, 0, 0], atol=1e-6)


# ------------------------------------------------------ full-sequence GQA
ONE_BLOCK = [dict(causal=True), dict(causal=False),
             dict(causal=True, window=3), dict(causal=False, window=4),
             dict(causal=True, qk_norm=True),
             dict(causal=True, window=5, qk_norm=True)]


@pytest.mark.parametrize("kw", ONE_BLOCK,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_attention_dense_one_block_matches_jax(kw):
    jp, tp = _attn_params(1, kw.get("qk_norm", False))
    x = _x(2, (2, 12, D))
    args = dict(n_heads=H, n_kv=KV, d_head=DH, rope_theta=1e4, **kw)
    want = jtfm.attention_dense(jp, jnp.asarray(x), **args)
    got = ttfm.attention_dense(tp, torch.from_numpy(x), **args)
    assert got.dtype == torch.float32
    _close(got, want)


# Windows with N - kv_block < window: no query row's first KV block is
# fully masked, where the reference's recurrence is defined everywhere.
BLOCKWISE = [dict(causal=True, kv_block=4), dict(causal=False, kv_block=8),
             dict(causal=True, kv_block=8, window=10),
             dict(causal=True, kv_block=4, window=13),
             dict(causal=False, kv_block=4, window=14),
             dict(causal=True, kv_block=4, qk_norm=True)]


@pytest.mark.parametrize("kw", BLOCKWISE,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_attention_dense_blockwise_matches_jax(kw):
    jp, tp = _attn_params(3, kw.get("qk_norm", False))
    x = _x(4, (2, 16, D))
    args = dict(n_heads=H, n_kv=KV, d_head=DH, **kw)
    want = jtfm.attention_dense(jp, jnp.asarray(x), **args)
    assert np.isfinite(_f(want)).all()
    got = ttfm.attention_dense(tp, torch.from_numpy(x), **args)
    _close(got, want)
    one_block = ttfm.attention_dense(tp, torch.from_numpy(x),
                                     **{**args, "kv_block": 16})
    _close(got, one_block)


def test_blockwise_rows_with_a_hidden_first_block_equal_the_one_block_form():
    """N = 8, kv_block = 2, window = 2: rows 3-7 see no key of the first
    block. The reference's blockwise recurrence gives NaN there
    (exp(-inf - -inf)); the port's equals the reference's one-block
    softmax on every row, and the reference's blockwise on rows 0-2."""
    jp, tp = _attn_params(5)
    x = _x(6, (2, 8, D))
    args = dict(n_heads=H, n_kv=KV, d_head=DH, causal=True, window=2)
    ref_block = _f(jtfm._blockwise_attention(
        *[jnp.asarray(_x(7 + i, (2, H, 8, DH))) for i in range(3)],
        DH ** -0.5, True, 2, 2))
    assert np.isnan(ref_block[:, :, 3:]).all()
    assert np.isfinite(ref_block[:, :, :3]).all()
    got = ttfm.attention_dense(tp, torch.from_numpy(x), kv_block=2, **args)
    assert torch.isfinite(got).all()
    _close(got, jtfm.attention_dense(jp, jnp.asarray(x), kv_block=8, **args))
    q, k, v = (torch.from_numpy(_x(7 + i, (2, H, 8, DH))) for i in range(3))
    port_block = ttfm._blockwise_attention(q, k, v, DH ** -0.5, True, 2, 2)
    _close(port_block[:, :, :3], ref_block[:, :, :3])
    with pytest.raises(ValueError, match="multiple of kv_block"):
        ttfm._blockwise_attention(q, k, v, DH ** -0.5, True, None, 3)


# --------------------------------------------------------------- decode
def _caches(seed, b, s):
    """A bf16 cache of random rows in both packages."""
    k = _x(seed, (b, s, KV, DH))
    v = _x(seed + 1, (b, s, KV, DH))
    jc = jtfm.KVCache(jnp.asarray(k).astype(jnp.bfloat16),
                      jnp.asarray(v).astype(jnp.bfloat16))
    tc = ttfm.KVCache(torch.from_numpy(_f(jc.k)).bfloat16(),
                      torch.from_numpy(_f(jc.v)).bfloat16())
    return jc, tc


DECODE = [dict(pos=5), dict(pos=[2, 9, 0]), dict(pos=[7, 3, 11], window=4),
          dict(pos=[1, 6, 4], qk_norm=True)]


@pytest.mark.parametrize("masked", [True, False], ids=["one_hot", "index"])
@pytest.mark.parametrize("kw", DECODE,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_attention_dense_decode_matches_jax(kw, masked):
    kw = dict(kw)
    pos = kw.pop("pos")
    jp, tp = _attn_params(8, kw.get("qk_norm", False))
    x = _x(9, (3, D))
    jc, tc = _caches(10, 3, 12)
    args = dict(n_heads=H, n_kv=KV, d_head=DH, masked_cache_update=masked,
                **kw)
    jpos = jnp.asarray(pos, jnp.int32)
    want, jnew = jtfm.attention_dense_decode(jp, jnp.asarray(x), jc, jpos,
                                             **args)
    got, tnew = ttfm.attention_dense_decode(
        tp, torch.from_numpy(x), tc,
        pos if np.ndim(pos) == 0 else torch.tensor(pos), **args)
    _close(got, want)
    for a, b in zip(tnew, jnew):
        assert a.dtype == torch.bfloat16
        _close(a, b, BF16_TOL)
    # every row but each slot's written one is the input cache's, bitwise
    rows = np.broadcast_to(np.asarray(pos), (3,))
    keep = np.ones((3, 12), bool)
    keep[np.arange(3), rows] = False
    for a, old in zip(tnew, tc):
        assert torch.equal(a[torch.from_numpy(keep)],
                           old[torch.from_numpy(keep)])


def test_decode_cache_write_forms_agree_and_leave_the_input_alone():
    _, tp = _attn_params(11)
    x = torch.from_numpy(_x(12, (3, D)))
    _, tc = _caches(13, 3, 8)
    before = [t.clone() for t in tc]
    pos = torch.tensor([0, 7, 3])
    a, ca = ttfm.attention_dense_decode(tp, x, tc, pos, n_heads=H, n_kv=KV,
                                        d_head=DH, masked_cache_update=True)
    b, cb = ttfm.attention_dense_decode(tp, x, tc, pos, n_heads=H, n_kv=KV,
                                        d_head=DH, masked_cache_update=False)
    assert torch.equal(a, b)
    assert all(torch.equal(u, w) for u, w in zip(ca, cb))
    assert all(torch.equal(u, w) for u, w in zip(tc, before))


def test_decode_steps_equal_the_full_sequence_rows():
    """Decoding token by token into an empty cache (f32 cache, so no bf16
    rounding of K / V) gives the full-sequence causal attention's rows."""
    _, tp = _attn_params(14, True)
    x = torch.from_numpy(_x(15, (2, 9, D)))
    args = dict(n_heads=H, n_kv=KV, d_head=DH, window=4, qk_norm=True)
    full = ttfm.attention_dense(tp, x, causal=True, **args)
    cache = ttfm.kv_cache_init(2, 12, KV, DH, dtype=torch.float32,
                               device="cpu")
    for i in range(9):
        out, cache = ttfm.attention_dense_decode(tp, x[:, i], cache, i,
                                                 **args)
        _close(out, full[:, i])


# ------------------------------------------------------------ the dense LM
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


def _tol(tag):
    return F32_TOL if tag == "f32" else BF16_TOL


def _tokens(batch, seq, seed=0):
    return markov_tokens(seed, 0, 0, batch, seq, CFG.vocab)[:, :seq]


def _kv_arrays(state):
    return [t for st in state for t in st.kv]


def test_dense_prefill_and_forward_hidden_match_jax(trees):
    tag, jp, tp = trees
    toks = _tokens(2, 16, seed=1)
    jt = jnp.asarray(toks)
    with torch.inference_mode():
        got_h = tlm.forward_hidden(TCFG, tp, torch.from_numpy(toks).long(),
                                   False)
        got = tlm.prefill(TCFG, tp, torch.from_numpy(toks).long(), False)
    assert got.dtype == torch.float32 and got_h.dtype == tp["embed"].dtype
    assert tuple(got_h.shape) == (2, 16, CFG.d_model)
    _close(got_h, jlm.forward_hidden(CFG, jp, jt, False), _tol(tag))
    _close(got, jlm.prefill(CFG, jp, jt, False), _tol(tag))


def test_dense_decode_steps_match_jax_logits_and_cache(trees):
    tag, jp, tp = trees
    toks = _tokens(3, 5, seed=2)
    jst = jlm.init_decode_state(CFG, 3, 8, False)
    tst = tlm.init_decode_state(TCFG, 3, 8, False, device="cpu")
    assert [(tuple(t.shape), t.dtype) for t in _kv_arrays(tst)] == \
        [(tuple(t.shape), torch.bfloat16) for t in _kv_arrays(jst)]
    assert all(st.sdsa is None for st in tst)
    pos = np.array([0, 2, 1])
    for i in range(toks.shape[1]):
        jl, jst = jlm.decode_step(CFG, jp, jst, jnp.asarray(toks[:, i]),
                                  jnp.asarray(pos + i, jnp.int32), False)
        with torch.inference_mode():
            tl, tst = tlm.decode_step(TCFG, tp, tst,
                                      torch.from_numpy(toks[:, i]).long(),
                                      torch.from_numpy(pos + i), False)
        _close(tl, jl, _tol(tag))
        for a, b in zip(_kv_arrays(tst), _kv_arrays(jst)):
            _close(a, b, BF16_TOL)


def test_dense_prefill_with_state_matches_jax(trees):
    tag, jp, tp = trees
    toks = _tokens(2, 6, seed=3)
    jl, jst = jlm.prefill_with_state(CFG, jp, jnp.asarray(toks), False,
                                     max_seq=10)
    with torch.inference_mode():
        tl, tst = tlm.prefill_with_state(TCFG, tp,
                                         torch.from_numpy(toks).long(), False,
                                         max_seq=10)
    _close(tl, jl, _tol(tag))
    for a, b in zip(_kv_arrays(tst), _kv_arrays(jst)):
        assert tuple(a.shape) == (CFG.n_layers, 2, 10, CFG.n_kv_heads,
                                  CFG.head_dim)
        _close(a, b, BF16_TOL)


def test_dense_prefill_chunked_with_ragged_lengths_matches_jax(trees):
    """Right-padded prompts of lengths (5, 8, 3): the last live logits and
    the caches as repro's; a pad step leaves a slot's KV rows bitwise as
    they were (zero past its length); each slot within the dtype's
    tolerance of its prompt run alone."""
    tag, jp, tp = trees
    toks = _tokens(3, 8, seed=4)
    lengths = np.array([5, 8, 3], np.int32)
    jl, jst = jlm.prefill_chunked(CFG, jp, jnp.asarray(toks),
                                  jnp.asarray(lengths), False, 16)
    with torch.inference_mode():
        tl, tst = tlm.prefill_chunked(TCFG, tp, torch.from_numpy(toks).long(),
                                      torch.from_numpy(lengths), False, 16)
    _close(tl, jl, _tol(tag))
    for a, b in zip(_kv_arrays(tst), _kv_arrays(jst)):
        _close(a, b, BF16_TOL)
        for slot, n in enumerate(lengths):
            assert not a[:, slot, n:].any()
            assert a[:, slot, :n].abs().amax(dim=(-1, -2)).all()
    for slot, n in enumerate(lengths):
        with torch.inference_mode():
            sl, solo = tlm.prefill_chunked(
                TCFG, tp, torch.from_numpy(toks[slot:slot + 1, :n]).long(),
                torch.tensor([n]), False, 16)
        _close(sl[0], tl[slot], _tol(tag))
        for a, b in zip(_kv_arrays(solo), _kv_arrays(tst)):
            _close(a[:, 0], b[:, slot], BF16_TOL)


def test_dense_prefill_agrees_with_prefill_chunked():
    """f32 trees: the full-sequence prefill and the streaming one give the
    same last-position logits up to the bf16 KV cache's rounding."""
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jlm.init_params(CFG, jax.random.PRNGKey(1)))
    tp = params_from_numpy(_np(jp), device="cpu")
    toks = torch.from_numpy(_tokens(2, 10, seed=5)).long()
    with torch.inference_mode():
        full = tlm.prefill(TCFG, tp, toks, False)
        streamed, _ = tlm.prefill_chunked(TCFG, tp, toks,
                                          torch.tensor([10, 10]), False, 16)
        with_state, _ = tlm.prefill_with_state(TCFG, tp, toks, False)
    _close(streamed, full, BF16_TOL)
    _close(with_state, streamed)


def test_shared_pos_max_is_wrong_vector_pos_is_right():
    """The reference's regression on the port: stepping a staggered pool
    at the shared ``pos.max()`` diverges from solo decode, while the
    per-slot vector matches to 1e-5. Dense mode: the KV write index, the
    RoPE angle and the causal mask are what consume pos."""
    params = tlm.init_params(TCFG, seed=0, device="cpu")
    prompt = [int(t) for t in _tokens(1, 5, seed=6)[0]]
    b1 = len(prompt)
    with torch.inference_mode():
        logits_solo, st_solo = tlm.prefill_chunked(
            TCFG, params, torch.tensor([prompt]), torch.tensor([b1]), False,
            64)
        next_tok = logits_solo.argmax(-1)
        ref_logits, _ = tlm.decode_step(TCFG, params, st_solo, next_tok, b1,
                                        False)
        pool = tlm.init_decode_state(TCFG, 2, 64, False, device="cpu")
        pool = tlm.merge_slot_state(pool, st_solo, 1)
        pos = torch.tensor([b1 + 5, b1])                    # staggered
        tok = torch.tensor([0, int(next_tok[0])])
        good, _ = tlm.decode_step(TCFG, params, pool, tok, pos, False)
        bad, _ = tlm.decode_step(TCFG, params, pool, tok,
                                 int(pos.max()), False)
    np.testing.assert_allclose(good[1].numpy(), ref_logits[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(bad[1].numpy(), ref_logits[0].numpy(),
                           rtol=1e-3, atol=1e-3)
