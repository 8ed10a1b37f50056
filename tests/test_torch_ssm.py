"""The recurrent-state blocks (`repro_torch.models.ssm`: Mamba, mLSTM,
sLSTM) against the JAX package's `repro.models.ssm`, on the CPU.

Params are the reference's inits moved through `params_from_numpy`;
inputs are numpy, from a seed. Each block runs over a whole sequence
from its zero state and from a carried state (the reference's state of
an earlier chunk, given to both packages), at N = 1 (a decode step), 2
(shorter than Mamba's conv history) and 7.

Tolerances:
  * bf16 trees, against the reference run op by op (`jax.disable_jit()`):
    the mLSTM's and sLSTM's outputs bit for bit. Mamba's within one bf16
    ulp (2^-8) of max|ref|, with at least 99% of its values equal, and
    its h state likewise: its bf16 GEMMs (`xc @ x_proj` here) sum their
    f32 terms in another order than XLA's dot, so a product that lies
    within an f32 ulp of a bf16 rounding midpoint lands one bf16 ulp
    apart, and that dt or B value enters the recurrence;
  * f32 trees, against the reference compiled: outputs within 2^-8 of
    max|ref|. Each scan step rounds its output to bf16 whatever the
    params' dtype (`repro/models/ssm.py:68`, `:155`, `:241`), and XLA and
    PyTorch sum the steps' reductions in other orders, so a one-ulp f32
    difference can move a whole bf16 step;
  * the carried f32 states (Mamba's h, the mLSTM's c, n, m, the sLSTM's
    c, n, h, m): within 1e-5 of max|ref| in both dtypes (Mamba's h in
    bf16: as its output); Mamba's bf16 conv window exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import params_from_numpy

torch.set_num_threads(2)
D_MODEL, N_HEADS, D_STATE, D_CONV = 32, 4, 16, 4
BATCH = 3
STATE_TOL = 1e-5
F32_TOL = 2.0 ** -8
BF16_ULP = 2.0 ** -8
FAMILIES = ("mamba", "mlstm", "slstm")
STATES = {"mamba": tssm.MambaState, "mlstm": tssm.MLSTMState,
          "slstm": tssm.SLSTMState}
_PARAMS: dict = {}


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _trees(family, tag):
    """(repro params, port params) of one block at D_MODEL, f32 or bf16."""
    if (family, tag) not in _PARAMS:
        key = jax.random.PRNGKey(11)
        if family == "mamba":
            jp = jssm.mamba_init(key, D_MODEL, D_STATE, D_CONV)
        else:
            jp = getattr(jssm, f"{family}_init")(key, D_MODEL, N_HEADS)
        if tag == "f32":
            jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        _PARAMS[family, tag] = (jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _PARAMS[family, tag]


def _apply(pkg, family, p, x, state):
    """(out, new state) of `family`'s apply in the package `pkg`."""
    if family == "mamba":
        return pkg.mamba_apply(p, x, state, D_STATE, D_CONV)
    return getattr(pkg, f"{family}_apply")(p, x, N_HEADS, state)


def _x(n, tag, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, n, D_MODEL)).astype(np.float32)
    dt = (jnp.float32, torch.float32) if tag == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    jx = jnp.asarray(x).astype(dt[0])
    return jx, torch.from_numpy(_f(jx).copy()).to(dt[1])


def _carried(family, jp):
    """The reference's state after a 5-token chunk (compiled), and the
    same state as port tensors."""
    jx, _ = _x(5, "f32", seed=9)
    _, jst = _apply(jssm, family, jp, jx.astype(jax.tree.leaves(jp)[0]
                                                 .dtype), None)
    tst = STATES[family](*(torch.from_numpy(np.array(jnp.asarray(leaf)
                           .astype(jnp.float32))).to(
                               torch.bfloat16 if leaf.dtype == jnp.bfloat16
                               else torch.float32) for leaf in jst))
    return jst, tst


def _check_state(got, want, tol=STATE_TOL):
    assert type(got).__name__ == type(want).__name__
    for name, a, b in zip(got._fields, got, want):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), name
        assert tuple(a.shape) == b.shape, name
        if a.dtype == torch.bfloat16:            # Mamba's conv window
            np.testing.assert_array_equal(_f(a), _f(b), err_msg=name)
        else:
            b = _f(b)
            np.testing.assert_allclose(_f(a), b, rtol=0,
                                       atol=tol * np.abs(b).max(),
                                       err_msg=name)


@pytest.mark.parametrize("n", [1, 2, 7])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("tag", ["bf16", "f32"])
@pytest.mark.parametrize("family", FAMILIES)
def test_block_matches_repro(family, tag, carried, n):
    jp, tp = _trees(family, tag)
    jst, tst = _carried(family, jp) if carried else (None, None)
    jx, tx = _x(n, tag, seed=n)
    if tag == "bf16":
        with jax.disable_jit():
            want, want_st = _apply(jssm, family, jp, jx, jst)
    else:
        want, want_st = _apply(jssm, family, jp, jx, jst)
    with torch.inference_mode():
        got, got_st = _apply(tssm, family, tp, tx, tst)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    g, w = _f(got), _f(want)
    if tag == "bf16" and family != "mamba":
        np.testing.assert_array_equal(g, w)
        _check_state(got_st, want_st)
        return
    tol = BF16_ULP if tag == "bf16" else F32_TOL
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max())
    if tag == "bf16":
        assert (g == w).mean() >= 0.99
    _check_state(got_st, want_st, BF16_ULP if tag == "bf16" else STATE_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_state_init_matches_repro(family):
    if family == "mamba":
        want = jssm.mamba_state_init(BATCH, D_MODEL, D_STATE, D_CONV, 2)
        got = tssm.mamba_state_init(BATCH, D_MODEL, D_STATE, D_CONV, 2,
                                    device="cpu")
    elif family == "mlstm":
        want = jssm.mlstm_state_init(BATCH, D_MODEL, N_HEADS)
        got = tssm.mlstm_state_init(BATCH, D_MODEL, N_HEADS, device="cpu")
    else:
        want = jssm.slstm_state_init(BATCH, D_MODEL)
        got = tssm.slstm_state_init(BATCH, D_MODEL, device="cpu")
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        np.testing.assert_array_equal(_f(a), _f(b))


@pytest.mark.parametrize("d_model", [32, 8192])
@pytest.mark.parametrize("family", FAMILIES)
def test_init_tree_matches_repro(family, d_model):
    """Leaf names, shapes and dtypes (Mamba's dt_rank = max(16, d / 16):
    512 at jamba's d 8192); at d 8192 on the meta device, shapes only."""
    heads = 64 if d_model == 8192 else N_HEADS
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    dev = "meta" if d_model == 8192 else "cpu"
    if family == "mamba":
        want = jax.eval_shape(lambda k: jssm.mamba_init(k, d_model), key)
        got = tssm.mamba_init(d_model, generator=gen, device=dev)
    else:
        want = jax.eval_shape(lambda k: getattr(jssm, f"{family}_init")(
            k, d_model, heads), key)
        got = getattr(tssm, f"{family}_init")(d_model, heads, generator=gen,
                                              device=dev)
    jl, jt = jax.tree_util.tree_flatten(want)
    tl, tt = jax.tree_util.tree_flatten(got)
    assert jt == tt
    assert [(tuple(a.shape), str(a.dtype)) for a in jl] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tl]
    if family == "mamba":
        assert tuple(got["x_proj"].shape) == (
            2 * d_model, max(16, d_model // 16) + 2 * D_STATE)
    if dev == "cpu":
        # The deterministic leaves equal the reference's; `a_log` (log of
        # 1..d_state) within one f32 ulp: PyTorch's log rounds correctly
        # and XLA's is one ulp off at some of the 16 values.
        jfull = (jssm.mamba_init(key, d_model) if family == "mamba"
                 else getattr(jssm, f"{family}_init")(key, d_model, heads))
        for name in {"mamba": ("a_log", "d_skip"), "mlstm": ("norm",
                     "out_norm"), "slstm": ("norm",)}[family]:
            for a, b in zip(jax.tree.leaves(got[name]),
                            jax.tree.leaves(jfull[name])):
                np.testing.assert_array_max_ulp(_f(a), _f(b), maxulp=1)
        if family == "mamba":
            np.testing.assert_array_equal(
                _f(got["a_log"]), np.log(np.arange(1, D_STATE + 1))
                .astype(np.float32)[None].repeat(2 * d_model, 0))


def test_mamba_history_is_the_last_window_rows():
    """The carried conv window is the last d_conv - 1 rows of [history;
    the chunk's conv inputs], for chunks shorter and longer than it."""
    jp, tp = _trees("mamba", "bf16")
    _, tst = _carried("mamba", jp)
    d_inner = tp["in_proj"].shape[-1] // 2
    for n in (1, 2, 3, 6):
        _, tx = _x(n, "bf16", seed=20 + n)
        with torch.inference_mode():
            _, st = tssm.mamba_apply(tp, tx, tst, D_STATE, D_CONV)
        xs = (tx @ tp["in_proj"])[..., :d_inner]
        rows = torch.cat([tst.conv, xs], dim=1)[:, -(D_CONV - 1):]
        assert torch.equal(st.conv, rows)
