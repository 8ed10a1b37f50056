"""The port's shard planners against `repro.core.spikes`', on the CPU.

The same seeded maps, made with numpy, go through `repro`'s
`rebalance_shard_plan` / `shard_occupancy_to_csr` and the port's: the
plan (permutation, pre / post counts) and every shard's `TileCSR` (work
list, counts, cap) must match EXACTLY. The properties of
`tests/test_rebalance_properties.py` are held on the port's planner too
(on the `hypothesis_compat` shim), and the port refuses a map on the card
where `repro` refuses a tracer.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from hypothesis_compat import given, st  # noqa: E402
from test_csr_properties import check_csr_invariants  # noqa: E402

from repro.core import spikes as jspikes
from repro_torch.core import spikes as tspikes

FIELDS = tspikes.CSR_FIELDS


def _random_map(shards: int, rows: int, kt: int, seed: int,
                density: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.random((shards * rows, kt)) < density)
            * rng.integers(1, 9, (shards * rows, kt))).astype(np.int32)


def _hot_band(mt: int, kt: int, seed: int) -> np.ndarray:
    """Every occupied tile in the first quarter of the tile rows."""
    occ = np.zeros((mt, kt), np.int32)
    band = max(1, mt // 4)
    occ[:band] = _random_map(1, band, kt, seed, 0.7)
    return occ


def _same_plan(occ_np: np.ndarray, shards: int):
    jp = jspikes.rebalance_shard_plan(jnp.asarray(occ_np), shards)
    tp = tspikes.rebalance_shard_plan(torch.from_numpy(occ_np), shards)
    np.testing.assert_array_equal(tp.perm, jp.perm)
    assert tp.pre_per_shard == jp.pre_per_shard
    assert tp.post_per_shard == jp.post_per_shard
    assert (tp.identity, tp.improves) == (jp.identity, jp.improves)
    np.testing.assert_array_equal(tp.inverse(), jp.inverse())
    return jp, tp


def _same_csrs(occ_np: np.ndarray, shards: int, jplan=None, tplan=None):
    jc = jspikes.shard_occupancy_to_csr(jnp.asarray(occ_np), shards,
                                        tiling=(128, 128), plan=jplan)
    tc = tspikes.shard_occupancy_to_csr(torch.from_numpy(occ_np), shards,
                                        tiling=(128, 128), plan=tplan)
    assert len(tc) == len(jc) == shards
    for a, b in zip(tc, jc):
        assert a.n_steps == b.n_steps
        assert (a.tiling, a.map_shape) == (tuple(b.tiling),
                                           tuple(b.map_shape))
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)), f)
    return tc


# -------------------------------------------------- exact against repro
@pytest.mark.parametrize("shards,rows,kt,seed,density", [
    (8, 2, 3, 0, 0.4), (8, 16, 4, 1, 0.1), (4, 5, 2, 2, 0.9),
    (2, 3, 6, 3, 0.0), (8, 1, 3, 4, 0.5), (1, 7, 3, 5, 0.3)])
def test_plan_and_shard_csrs_equal_repro(shards, rows, kt, seed, density):
    occ_np = _random_map(shards, rows, kt, seed, density)
    jp, tp = _same_plan(occ_np, shards)
    _same_csrs(occ_np, shards)
    _same_csrs(occ_np, shards, jp, tp)


@pytest.mark.parametrize("mt,kt,shards", [(64, 4, 8), (128, 12, 8),
                                          (16, 1, 8), (32, 3, 4)])
def test_hot_band_plans_equal_repro_and_improve(mt, kt, shards):
    """The chip phase's case: a hot band in the first quarter of the rows
    (SpikingFormer's fc1 grid is (64, 3), stage 1's (1024, 4))."""
    occ_np = _hot_band(mt, kt, mt + kt)
    jp, tp = _same_plan(occ_np, shards)
    assert tp.improves and max(tp.post_per_shard) < max(tp.pre_per_shard)
    tc = _same_csrs(occ_np, shards, jp, tp)
    stack = tspikes.stack_shard_csrs(tc)
    assert stack.row_ptr.shape == (shards, mt // shards + 1)
    for a, b in zip(tspikes.unstack_shard_csrs(stack), tc):
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f))


def test_shard_csrs_move_to_a_device():
    occ_np = _random_map(4, 2, 3, 7, 0.5)
    tc = tspikes.shard_occupancy_to_csr(occ_np, 4, device="meta")
    assert all(getattr(c, f).device.type == "meta" for c in tc
               for f in FIELDS)


# ------------------------------------------------------- hypothesis side
@given(st.integers(1, 6), st.integers(1, 5), st.integers(1, 4),
       st.integers(0, 2 ** 30), st.floats(0.0, 1.0))
def test_plan_is_permutation_and_conserves_tiles(shards, rows, kt, seed,
                                                 density):
    occ_np = _random_map(shards, rows, kt, seed, density)
    plan = tspikes.rebalance_shard_plan(torch.from_numpy(occ_np), shards)
    mt = shards * rows
    assert sorted(plan.perm.tolist()) == list(range(mt))
    np.testing.assert_array_equal(plan.perm[plan.inverse()], np.arange(mt))
    total = int((occ_np > 0).sum())
    assert sum(plan.pre_per_shard) == sum(plan.post_per_shard) == total
    assert max(plan.post_per_shard) <= max(plan.pre_per_shard)
    for i in range(shards):
        sl = plan.perm[i * rows:(i + 1) * rows]
        assert np.all(np.diff(sl) > 0)
        assert plan.post_per_shard[i] == int((occ_np[sl] > 0).sum())


@given(st.integers(1, 5), st.integers(1, 4), st.integers(1, 4),
       st.integers(0, 2 ** 30), st.floats(0.0, 1.0))
def test_plan_deterministic_and_equal_to_repro(shards, rows, kt, seed,
                                               density):
    occ_np = _random_map(shards, rows, kt, seed, density)
    a = tspikes.rebalance_shard_plan(torch.from_numpy(occ_np), shards)
    b = tspikes.rebalance_shard_plan(occ_np.copy(), shards)
    np.testing.assert_array_equal(a.perm, b.perm)
    assert a.pre_per_shard == b.pre_per_shard
    assert a.post_per_shard == b.post_per_shard
    _same_plan(occ_np, shards)


@given(st.integers(1, 4), st.integers(1, 4), st.integers(0, 2 ** 30))
def test_plan_aware_shard_csr_shares_cap_and_holds_invariants(shards, rows,
                                                              seed):
    kt = 3
    occ_np = _random_map(shards, rows, kt, seed, 0.4)
    plan = tspikes.rebalance_shard_plan(occ_np, shards)
    per = tspikes.shard_occupancy_to_csr(torch.from_numpy(occ_np), shards,
                                         plan=plan)
    caps = {c.n_steps for c in per}
    assert len(caps) == 1, "shards must share one cap"
    cap = caps.pop()
    assert cap <= rows * kt
    assert cap == tspikes.pow2_step_cap(cap, rows * kt)
    for i, csr in enumerate(per):
        check_csr_invariants(occ_np[plan.perm[i * rows:(i + 1) * rows]],
                             csr, cap=cap)


# ----------------------------------------------- deterministic fallbacks
def test_empty_map_identity_plan_and_dummy_grids():
    occ_np = np.zeros((8, 3), np.int32)
    plan = tspikes.rebalance_shard_plan(occ_np, 4)
    assert plan.identity and not plan.improves
    assert plan.pre_per_shard == plan.post_per_shard == (0, 0, 0, 0)
    for csr in tspikes.shard_occupancy_to_csr(occ_np, 4, plan=plan):
        check_csr_invariants(occ_np[:2], csr)
        assert int(csr.valid.sum()) == 2 and int(csr.occ.sum()) == 0


def test_hotspot_band_improves_and_default_split_unchanged():
    occ_np = np.array([[1, 1, 1], [1, 1, 0], [0, 1, 0], [0, 1, 0],
                       [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]],
                      np.int32)
    plan = tspikes.rebalance_shard_plan(occ_np, 4)
    assert plan.pre_per_shard == (5, 2, 0, 0)
    assert max(plan.post_per_shard) < 5 and plan.improves
    for i, csr in enumerate(tspikes.shard_occupancy_to_csr(occ_np, 4)):
        check_csr_invariants(occ_np[2 * i:2 * i + 2], csr, cap=csr.n_steps)


def test_one_row_per_shard_cannot_improve():
    occ_np = np.array([[3, 3], [0, 0], [0, 0], [0, 0]], np.int32)
    plan = tspikes.rebalance_shard_plan(occ_np, 4)
    assert not plan.improves
    assert max(plan.post_per_shard) == max(plan.pre_per_shard) == 2


def test_plan_rejects_card_maps_uneven_rows_and_mismatched_use():
    """The same errors as `repro` on uneven rows and a plan for another
    map; a map off the host is refused (`repro` refuses a tracer): the
    caller reads it explicitly."""
    with pytest.raises(ValueError, match="divisible"):
        tspikes.rebalance_shard_plan(torch.zeros(3, 2, dtype=torch.int32),
                                     2)
    with pytest.raises(ValueError, match="divisible"):
        tspikes.shard_occupancy_to_csr(np.zeros((3, 2), np.int32), 2)
    for fn in (tspikes.rebalance_shard_plan, tspikes.shard_occupancy_to_csr):
        with pytest.raises(ValueError, match="explicitly"):
            fn(torch.zeros(4, 2, dtype=torch.int32, device="meta"), 2)
    plan = tspikes.rebalance_shard_plan(np.zeros((4, 2), np.int32), 2)
    with pytest.raises(ValueError, match="plan covers"):
        tspikes.shard_occupancy_to_csr(np.zeros((8, 2), np.int32), 2,
                                       plan=plan)
    a, b = tspikes.shard_occupancy_to_csr(
        np.array([[1, 1], [0, 0]], np.int32), 2)
    with pytest.raises(ValueError, match="caps differ"):
        tspikes.stack_shard_csrs([a, a._replace(
            tile_k_idx=a.tile_k_idx[:1], tile_m_idx=a.tile_m_idx[:1],
            occ=a.occ[:1], valid=a.valid[:1])])
