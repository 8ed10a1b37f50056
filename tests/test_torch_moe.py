"""The MoE layer (`models/moe.py`) in repro_torch against the JAX package's
`repro.models.moe`, on the CPU.

The same params (the reference's `moe_init`, moved through
`params_from_numpy`) and the same inputs (numpy, from a seed) go into
both `moe_apply`s: random drives (dense mode) and binary spike tensors
with a leading T axis (spiking mode), spiking or dense, one or two
dispatch groups, a padded expert bank, unnormalised gate weights, shared
experts or none, a capacity factor low enough to drop assignments, and
all-zero spike rows (tied router probabilities). The reference runs op
by op, as `moe_apply` is written.

Tolerances:
  * f32 params and inputs: within 1e-5 of max|ref| (the router's f32
    product and the expert GEMMs sum in other orders than XLA's);
  * bf16 params and inputs (the model's dtypes): bit for bit. Both sum a
    bf16 product in f32 and round once, the expert fire is exact, and
    the combine adds each token's k weighted outputs in rising expert id
    with one bf16 rounding per add, as the reference's scatter-add does;
  * routing (expert ids, kept slots): exact, ties to the lower id;
  * gradients (f32): within 1e-5 * max|ref| + 1e-7 per leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lif import LIFConfig as JLIF
from repro.models import moe as jmoe
from repro_torch.core.lif import LIFConfig
from repro_torch.kernels import dispatch
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import params_from_numpy

torch.set_num_threads(2)
F32_TOL = 1e-5
D, F, E, K = 64, 32, 8, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _params(tag, n_shared=2, bank_size=0, seed=1):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), D, F, E, n_shared,
                       bank_size=bank_size)
    if tag == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, params_from_numpy(_np(jp), device="cpu")


def _input(tag, spiking, shape=(2, 2, 16), seed=0, zero_rows=0.0):
    """(T, B, N, D) spikes at 30% (spiking) or (B, N, D) N(0, 1) drives; a
    share `zero_rows` of the spike rows all zero."""
    rng = np.random.default_rng(seed)
    if spiking:
        x = (rng.random(shape + (D,)) < 0.3).astype(np.float32)
        x[rng.random(shape) < zero_rows] = 0.0
    else:
        x = rng.standard_normal(shape[1:] + (D,)).astype(np.float32)
    dt = jnp.float32 if tag == "f32" else jnp.bfloat16
    return jnp.asarray(x).astype(dt), torch.from_numpy(x).to(
        torch.float32 if tag == "f32" else torch.bfloat16)


def _check(tag, got, want):
    got, want = _f(got), _f(want)
    assert got.shape == want.shape
    if tag == "f32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=F32_TOL * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


CASES = {
    "shared": dict(),
    "no_shared": dict(n_shared=0),
    "groups2": dict(groups=2),
    "groups_ragged": dict(groups=3),            # 64 % 3: one group
    "bank_padding": dict(bank_size=12),
    "unnormalized": dict(normalize=False),
    "capacity_drops": dict(capacity_factor=0.3),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("spiking", [True, False], ids=["spiking", "dense"])
@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_moe_apply_matches_repro(tag, spiking, case):
    c = CASES[case]
    jp, tp = _params(tag, n_shared=c.get("n_shared", 2),
                     bank_size=c.get("bank_size", 0))
    jx, tx = _input(tag, spiking)
    kw = dict(top_k=K, capacity_factor=c.get("capacity_factor", 1.25),
              normalize_weights=c.get("normalize", True), spiking=spiking)
    want = jmoe.moe_apply(jp, jx, lif_cfg=JLIF(),
                          dispatch_groups=c.get("groups", 1), **kw)
    with torch.inference_mode():
        got = tmoe.moe_apply(tp, tx, lif_cfg=LIFConfig(),
                             dispatch_groups=c.get("groups", 1), **kw)
    assert got.dtype == tx.dtype
    _check(tag, got, want)
    if case == "capacity_drops":
        assert tmoe.dropped_assignments(
            tp, tx, top_k=K, capacity_factor=kw["capacity_factor"]) > 0


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_all_zero_spike_rows_tie_to_the_lowest_experts(tag, backend):
    """A token with no spikes has all-zero router logits, so its 8
    probabilities tie: `jax.lax.top_k` takes experts 0-3, and so must the
    port. Half the rows silent overflow those four experts' capacity."""
    jp, tp = _params(tag)
    jx, tx = _input(tag, True, zero_rows=0.5)
    xt = tx.reshape(-1, D)
    silent = ~(xt != 0).any(-1)
    assert int(silent.sum()) > 8
    cap = tmoe.capacity_of(xt.shape[0], K, E, 1.25)
    r = tmoe.route(tp["router"], xt, top_k=K, capacity=cap, e_bank=E)
    assert (r.ids[silent] == torch.arange(K)).all()
    logits = jnp.asarray(_f(xt)) @ jp["router"].astype(jnp.float32)
    _, jids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    np.testing.assert_array_equal(r.ids.numpy(), np.asarray(jids))
    assert int((~r.keep).sum()) > 0
    want = jmoe.moe_apply(jp, jx, top_k=K, spiking=True, lif_cfg=JLIF())
    with torch.inference_mode(), dispatch.use_backend(backend):
        got = tmoe.moe_apply(tp, tx, top_k=K, spiking=True,
                             lif_cfg=LIFConfig())
    _check(tag, got, want)


def test_stable_sort_top_k_matches_lax_top_k_on_ties():
    """Rows of equal probabilities, and rows with a few ties among
    distinct values: the same ids, best first, lower id first on a tie."""
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 4, (64, 60)).astype(np.float32) / 4
    probs[0] = 1 / 60
    top = torch.sort(torch.from_numpy(probs), dim=-1, descending=True,
                     stable=True)
    _, jids = jax.lax.top_k(jnp.asarray(probs), 4)
    np.testing.assert_array_equal(top.indices[:, :4].numpy(),
                                  np.asarray(jids))
    assert top.indices[0, :4].tolist() == [0, 1, 2, 3]


def test_route_matches_the_reference_sort_and_capacity_check():
    jp, tp = _params("f32")
    _, tx = _input("f32", True, shape=(2, 4, 16))
    xt = tx.reshape(-1, D)
    s, cap = xt.shape[0], 24
    r = tmoe.route(tp["router"], xt, top_k=K, capacity=cap, e_bank=E)
    # the reference's dispatch_one, step by step
    xl = jnp.asarray(xt.numpy())
    probs = jax.nn.softmax(xl @ jp["router"], axis=-1)
    w, ids = jax.lax.top_k(probs, K)
    w = w / jnp.sum(w, axis=-1, keepdims=True)
    flat = ids.reshape(-1)
    sort_idx = jnp.argsort(flat, stable=True)
    sorted_ids = flat[sort_idx]
    starts = jnp.searchsorted(sorted_ids, jnp.arange(E), side="left")
    rank = jnp.arange(s * K) - starts[sorted_ids]
    keep = rank < cap
    dest = jnp.where(keep, sorted_ids * cap + rank, E * cap)
    for a, b in ((r.ids, ids), (r.sort_idx, sort_idx), (r.keep, keep),
                 (r.dest, dest), (r.tok_idx, sort_idx // K)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(r.weights.numpy(), np.asarray(w), rtol=1e-6)
    assert int((~r.keep).sum()) > 0


@pytest.mark.parametrize("tokens,top_k,experts,factor,want", [
    (2048, 4, 60, 1.25, 176), (16, 4, 60, 1.25, 8), (64, 4, 8, 1.25, 40),
    (64, 4, 8, 0.3, 16), (1, 2, 16, 1.25, 8), (4096, 2, 8, 1.0, 1024)])
def test_capacity_rounds_up_to_8_with_a_floor_of_8(tokens, top_k, experts,
                                                   factor, want):
    assert tmoe.capacity_of(tokens, top_k, experts, factor) == want


@pytest.mark.parametrize("n_shared,bank_size", [(2, 0), (0, 12)])
def test_moe_init_tree_matches_repro(n_shared, bank_size):
    jp = jmoe.moe_init(jax.random.PRNGKey(0), D, F, E, n_shared,
                       bank_size=bank_size)
    gen = torch.Generator().manual_seed(0)
    tp = tmoe.moe_init(D, F, E, n_shared, bank_size=bank_size,
                       generator=gen, device="cpu")
    jl, jt = jax.tree_util.tree_flatten(jp)
    tl, tt = jax.tree_util.tree_flatten(tp)
    assert jt == tt
    assert [(a.shape, str(a.dtype)) for a in jl] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tl]
    bank = max(E, bank_size)
    assert tp["w_gate"].shape == (bank, D, F)
    assert tp["router"].shape == (D, E)
    # Glorot scale per expert matrix, truncated at 2 sigma (then rounded
    # to bf16)
    scale = (2.0 / (D + F)) ** 0.5
    w = tp["w_gate"].float()
    assert w.abs().max() <= 2 * scale * (1 + 2.0 ** -8)
    assert abs(w.std().item() - 0.88 * scale) < 0.1 * scale


def test_dead_experts_of_a_padded_bank_never_receive_a_token():
    """A bank padded from 8 to 12 experts routes as the first 8 alone: no
    kept slot lands in a dead expert's rows, and the output equals the
    unpadded bank's bit for bit."""
    _, tp = _params("bf16", bank_size=12)
    _, tx = _input("bf16", True)
    xt = tx.reshape(-1, D)
    cap = tmoe.capacity_of(xt.shape[0], K, E, 1.25)
    r = tmoe.route(tp["router"], xt, top_k=K, capacity=cap, e_bank=12)
    assert int(r.dest[r.keep].max()) < E * cap
    assert (r.dest[~r.keep] == 12 * cap).all()
    unpadded = {k: (v[:E] if k.startswith("w_") else v)
                for k, v in tp.items()}
    with torch.inference_mode():
        a = tmoe.moe_apply(tp, tx, top_k=K, spiking=True, lif_cfg=LIFConfig())
        b = tmoe.moe_apply(unpadded, tx, top_k=K, spiking=True,
                           lif_cfg=LIFConfig())
    assert torch.equal(a, b)


@pytest.mark.parametrize("spiking", [True, False], ids=["spiking", "dense"])
def test_shard_map_without_a_mesh_is_moe_apply_and_a_mesh_raises(spiking):
    jp, tp = _params("bf16")
    jx, tx = _input("bf16", spiking)
    want = jmoe.moe_apply_shard_map(jp, jx, top_k=K, spiking=spiking,
                                    lif_cfg=JLIF())
    with torch.inference_mode():
        got = tmoe.moe_apply_shard_map(tp, tx, top_k=K, spiking=spiking,
                                       lif_cfg=LIFConfig())
        plain = tmoe.moe_apply(tp, tx, top_k=K, spiking=spiking,
                               lif_cfg=LIFConfig())
    _check("bf16", got, want)
    assert torch.equal(got, plain)
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tmoe.moe_apply_shard_map(tp, tx, top_k=K, mesh=object())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aux_load_balance_loss_matches_repro(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((48, E)).astype(np.float32) * 2
    ids = np.argsort(-logits, axis=-1)[:, :K]
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(ids),
                                      E, K)
    got = tmoe.aux_load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(ids), E, K)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("spiking", [True, False], ids=["spiking", "dense"])
def test_moe_gradients_match_jax(spiking):
    """f32: the gradient of a weighted sum of the output, to every param
    leaf and to the (dense) input, against `jax.grad`. The router learns
    through the gate weights; the fires through the ATan surrogate."""
    jp, tp = _params("f32")
    jx, tx = _input("f32", spiking)
    cot = np.random.default_rng(5).standard_normal(
        tuple(tx.shape)).astype(np.float32)

    def jloss(p, x):
        y = jmoe.moe_apply(p, x, top_k=K, spiking=spiking, lif_cfg=JLIF())
        return jnp.sum(y * cot)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves, names = [], []
    for name, v in sorted(tp.items()):
        for sub, t in (sorted(v.items()) if isinstance(v, dict)
                       else [("", v)]):
            t.requires_grad_(True)
            leaves.append(t)
            names.append((name, sub))
    tx.requires_grad_(True)
    y = tmoe.moe_apply(tp, tx, top_k=K, spiking=spiking, lif_cfg=LIFConfig())
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                leaves + [tx])
    for (name, sub), g in zip(names + [("x", "")], grads):
        want = np.asarray(jg_x if name == "x" else
                          (jg_p[name][sub] if sub else jg_p[name]))
        err = np.abs(_f(g) - want).max()
        assert err <= F32_TOL * np.abs(want).max() + 1e-7, (name, sub, err)


def test_dropped_assignments_counts_what_the_capacity_check_drops():
    _, tp = _params("f32")
    _, tx = _input("f32", True, zero_rows=0.5)
    xt = tx.reshape(-1, D)
    for factor in (0.3, 1.25, 4.0):
        cap = tmoe.capacity_of(xt.shape[0], K, E, factor)
        r = tmoe.route(tp["router"], xt, top_k=K, capacity=cap, e_bank=E)
        counts = torch.bincount(r.ids.reshape(-1), minlength=E)
        want = int(torch.clamp(counts - cap, min=0).sum())
        assert tmoe.dropped_assignments(tp, tx, top_k=K,
                                        capacity_factor=factor) == want


def test_combine_adds_each_tokens_slots_in_rising_expert_order():
    """Four bf16 contributions whose sum depends on the order of the
    adds: the combine's result is the sorted (rising expert id) chain."""
    _, tp = _params("bf16")
    xt = torch.zeros((4, D), dtype=torch.bfloat16)   # ties: experts 0-3
    r = tmoe.route(tp["router"], xt, top_k=K, capacity=8, e_bank=E)
    vals = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -8, -1.0])
    eo = torch.zeros((E, 8, D), dtype=torch.bfloat16)
    for e in range(K):                  # expert e's rows: vals[e]
        eo[e] = vals[e] * K             # weights are 1/K each
    got = tmoe._combine(eo, r, 4, K)
    chain = torch.zeros((), dtype=torch.bfloat16)
    for e in range(K):
        chain = chain + (vals[e] * K).to(torch.bfloat16) * \
            torch.tensor(1 / K, dtype=torch.bfloat16)
    assert torch.equal(got, torch.full_like(got, chain.item()))
    # another order would round differently
    rev = torch.zeros((), dtype=torch.bfloat16)
    for e in (3, 1, 2, 0):
        rev = rev + (vals[e] * K).to(torch.bfloat16) * \
            torch.tensor(1 / K, dtype=torch.bfloat16)
    assert rev.item() != chain.item()
