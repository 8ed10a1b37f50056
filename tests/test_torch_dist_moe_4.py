"""The MoE configs on the four-rank meshes, (2, 2) and (1, 4): the cases,
rank bodies and yardsticks of `test_torch_dist_moe.py` (see its doc),
spawned in a world of four `gloo` ranks beside the reference's sharded
steps on four host devices."""
import pytest

import test_torch_dist_moe as moe_cases

COMBOS = moe_cases.combos(4)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return moe_cases.spawn_world(4, tmp_path_factory.mktemp("moe4"))


@pytest.mark.parametrize("combo", COMBOS, ids=moe_cases.combo_id)
def test_routing_equals_the_one_process_runs(four_ranks, combo):
    drops = moe_cases.check_routing(four_ranks["ranks"], *combo)
    # the reduced qwen2-moe as configured drops assignments for capacity,
    # so the drops are compared too
    assert combo[0] != "qwen" or any(drops), "the capacity binds nowhere"


@pytest.mark.parametrize("combo", COMBOS, ids=moe_cases.combo_id)
def test_served_pool_equals_the_one_process_pool(four_ranks, combo):
    moe_cases.check_served(four_ranks["ranks"], *combo)


@pytest.mark.parametrize("combo", COMBOS, ids=moe_cases.combo_id)
def test_moe_layer_is_bit_for_bit_the_one_process_layer(four_ranks, combo):
    moe_cases.check_layer(four_ranks["ranks"], *combo)


@pytest.mark.parametrize("combo", COMBOS, ids=moe_cases.combo_id)
def test_step_zero_meets_the_one_process_step(four_ranks, combo):
    moe_cases.check_step(four_ranks["ranks"], *combo)


@pytest.mark.parametrize("combo", [c for c in COMBOS
                                   if moe_cases.parted(*c[::-1])],
                         ids=moe_cases.combo_id)
def test_step_zero_is_the_batch_ranks_witness(four_ranks, combo):
    moe_cases.check_parts(four_ranks["ranks"], *combo)


@pytest.mark.parametrize("combo", COMBOS, ids=moe_cases.combo_id)
def test_every_block_is_the_same_bits_on_every_rank_that_holds_it(
        four_ranks, combo):
    moe_cases.check_blocks(four_ranks["ranks"], *combo)


@pytest.mark.parametrize("combo", COMBOS, ids=moe_cases.combo_id)
def test_f32_step_zero_matches_the_reference_sharded_step(four_ranks,
                                                         combo):
    moe_cases.check_jax(four_ranks["jax"], four_ranks["ranks"], *combo)


@pytest.mark.parametrize("combo", COMBOS, ids=moe_cases.combo_id)
def test_local_init_draws_the_seeds_local_params(four_ranks, combo):
    assert all(r[combo]["local_init"] for r in four_ranks["ranks"])
