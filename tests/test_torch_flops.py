"""The port's analytic step cost (`repro_torch.launch.flops`) and
parameter counts against the JAX package's, on the CPU.

Exact equality: both are the same Python float arithmetic on the same
config fields, so every `StepCost` field, `forward_flops` and
`param_bytes` must be equal for every registry config, full and reduced,
every assigned shape and both modes; `param_count` and
`active_param_count` likewise. The cross-check against a counted step
follows the reference's (`tests/test_system.py::
test_analytic_flops_cross_check`) with `torch.utils.flop_counter.
FlopCounterMode` over the port's dense training step in place of XLA's
`cost_analysis`: within 0.2-5 of each other.
"""
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import flops as jflops
from repro.models import lm as jlm
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LMConfig, SHAPES, ShapeSpec, \
    SpikingConfig
from repro_torch.launch import flops as tflops
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw

torch.set_num_threads(2)
SIZES = ("full", "reduced")


def _pair(arch, size):
    get = "get_config" if size == "full" else "get_reduced"
    return getattr(jreg, get)(arch), getattr(treg, get)(arch)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_step_cost_equals_repro_for_every_shape_and_mode(arch, size,
                                                        monkeypatch):
    jc, tc = _pair(arch, size)
    assert tflops.param_bytes(tc) == jflops.param_bytes(jc)
    # Each count walks the whole parameter tree; take both once per
    # config (held equal here and in the next test) for the 8 step costs.
    n, n_active = tlm.param_count(tc), tlm.active_param_count(tc)
    assert (n, n_active) == (jlm.param_count(jc), jlm.active_param_count(jc))
    for mod in (tflops, jlm):
        monkeypatch.setattr(mod, "param_count", lambda cfg: n)
        monkeypatch.setattr(mod, "active_param_count", lambda cfg: n_active)
    for shape in SHAPES:
        for spiking in (True, False):
            got = tflops.step_cost(tc, shape, spiking).asdict()
            want = jflops.step_cost(jc, shape, spiking).asdict()
            assert got == want, (shape.name, spiking)
            n_ctx = shape.seq_len
            for n_tokens in (1.0, float(shape.global_batch) * n_ctx):
                assert tflops.forward_flops(tc, n_tokens, n_ctx, spiking) \
                    == jflops.forward_flops(jc, n_tokens, n_ctx, spiking)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_param_and_active_param_counts_equal_repro(arch, size):
    jc, tc = _pair(arch, size)
    assert tlm.param_count(tc) == jlm.param_count(jc)
    assert tlm.active_param_count(tc) == jlm.active_param_count(jc)
    assert (tlm.active_param_count(tc) < tlm.param_count(tc)) == \
        (tc.moe is not None)


def test_step_cost_fields_and_remat_accounting():
    """Backward is twice the forward and remat "full" adds one forward:
    a training step's FLOPs are 3x (none) or 4x (full) the forward's, and
    `model_flops_6nd` is 6 x active params x tokens."""
    tc = treg.get_config("qwen2-moe-a2.7b")
    shape = ShapeSpec("t", 128, 8, "train")
    fwd = tflops.forward_flops(tc, 8.0 * 128, 128, True)
    full = tflops.step_cost(tc, shape, True)
    none = tflops.step_cost(tc.replace(remat="none"), shape, True)
    assert full.flops == 4.0 * fwd and none.flops == 3.0 * fwd
    assert full.model_flops_6nd == 6.0 * tlm.active_param_count(tc) * 1024
    assert full.useful_ratio == full.model_flops_6nd / full.flops


def test_analytic_flops_cross_check_against_a_counted_step():
    """The reference's cross-check on the port: the analytic training
    step's FLOPs over `FlopCounterMode`'s count of the port's dense
    `make_train_step` (forward, backward and AdamW) on a one-layer model,
    within 0.2-5."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = LMConfig(name="xc", family="dense", n_layers=1, d_model=128,
                   n_heads=4, n_kv_heads=4, d_ff=256, vocab=256,
                   spiking=SpikingConfig(t_steps=1), remat="none",
                   loss_chunk=64)
    shape = ShapeSpec("t", 64, 4, "train")
    params = tlm.init_params(cfg, seed=0, device="cpu")
    opt = adamw.init(params)
    batch = {"tokens": torch.zeros((4, 64), dtype=torch.long),
             "labels": torch.zeros((4, 64), dtype=torch.long)}
    step = tsteps.make_train_step(cfg, spiking=False)
    counter = FlopCounterMode(display=False)
    with counter:
        step(params, opt, batch)
    counted = float(counter.get_total_flops())
    analytic = tflops.step_cost(cfg, shape, spiking=False).flops
    ratio = analytic / counted
    print(f"analytic {analytic:.4g} counted {counted:.4g} ratio {ratio:.4f}")
    assert 0.2 < ratio < 5.0, (analytic, counted)
    assert np.isfinite(ratio)


@pytest.mark.parametrize("arch", ("xlstm-350m", "jamba-1.5-large-398b"))
def test_executed_train_flops_adds_the_nested_recompute(arch):
    """`step_cost` counts remat "full" as one recompute, the reference's
    count; the port's nested checkpoints run every block but its group's
    last once more. `executed_train_flops` adds that: equal to
    `step_cost` where nothing nests, about 4.9 forwards where an 8-block
    pattern nests. On a reduced two-block pattern, the matmul FLOPs that
    `FlopCounterMode` counts between remat "none" and "full" exceed one
    forward of the blocks (so one recompute undercounts them) and stay
    within `executed_train_flops`' difference less the LM head, whose
    cross-entropy chunks the port recomputes under every remat (an upper
    count: a checkpoint's recompute stops once it has what it saved)."""
    from torch.utils.flop_counter import FlopCounterMode
    full = treg.get_config(arch)
    shape = ShapeSpec("t", 128, 8, "train")
    none = full.replace(remat="none")
    assert tflops.executed_train_flops(none, shape, True) == \
        tflops.step_cost(none, shape, True).flops
    ratio = tflops.executed_train_flops(full, shape, True) / \
        tflops.step_cost(full, shape, True).flops
    assert 1.1 < ratio < 1.25, ratio
    cfg = treg.get_reduced(arch).replace(moe=None)
    assert len(tlm.layer_pattern(cfg)[0]) == 2
    b, s = 2, 16
    shape = ShapeSpec("t", s, b, "train")
    params = tlm.init_params(cfg, seed=0, device="cpu")
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {"tokens": torch.zeros((b, s), dtype=torch.long),
             "labels": torch.zeros((b, s), dtype=torch.long)}
    head = 2.0 * cfg.d_model * cfg.vocab * b * s
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        tlm.loss_fn(cfg, params, batch, False)
    blocks = float(counter.get_total_flops()) - head
    counted, executed = {}, {}
    for remat in ("none", "full"):
        c = cfg.replace(remat=remat)
        counter = FlopCounterMode(display=False)
        with counter:
            loss = tlm.loss_fn(c, params, batch, False)
            torch.autograd.grad(loss, leaves, allow_unused=True)
        counted[remat] = float(counter.get_total_flops())
        executed[remat] = tflops.executed_train_flops(c, shape, False)
    recompute = counted["full"] - counted["none"]
    upper = executed["full"] - executed["none"] - head
    print(f"{arch}: blocks' forward {blocks:.4g}, counted recompute "
          f"{recompute:.4g}, executed_train_flops' {upper:.4g}")
    assert blocks < recompute <= upper, (blocks, counted, executed, head)
