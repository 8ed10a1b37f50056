"""The port's checkpointing (`repro_torch.checkpoint`) against the JAX
package's, on the CPU.

The cases of tests/test_checkpoint.py on port trees (round trip,
corruption, an uncommitted checkpoint, retention, walk-back past a
corrupt, truncated or dropped leaf, all corrupt, manifest sizes, async
save), plus: checkpoints cross between the two packages both ways on the
reduced TinyLlama's (params, AdamW state), bf16 leaves included; an
async save that an in-place update follows keeps the saved values; a
restore shares no storage with its target. Every comparison is exact.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import checkpointer
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry as treg
from repro_torch.models import lm as tlm
from repro_torch.models.layers import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.runtime import faults

ARCH = "tinyllama-1.1b"


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 16, generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.randn(4, generator=g).to(torch.bfloat16)}}


def _equal_trees(a, b):
    la, lb = checkpointer._flatten(a), checkpointer._flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip_bitwise(tmp_path):
    tree = _tree()
    checkpointer.save(str(tmp_path), 5, tree)
    out = checkpointer.restore(str(tmp_path / "step_000000005"), tree)
    _equal_trees(tree, out)


def test_corruption_detected(tmp_path):
    tree = _tree()
    checkpointer.save(str(tmp_path), 1, tree)
    f = tmp_path / "step_000000001" / "leaf_00000.npy"
    data = bytearray(f.read_bytes())
    data[-1] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(IOError, match="checksum"):
        checkpointer.restore(str(tmp_path / "step_000000001"), tree)


def test_uncommitted_checkpoint_ignored(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(10, tree)
    bad = tmp_path / "step_000000020"
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps({"leaves": []}))
    assert mgr.latest_step() == 10


def test_rolling_retention(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.steps() == [3, 4]


def _two_saves(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    mgr.save(1, tree)
    mgr.save(2, _tree(1))
    return tree, mgr


def test_restore_latest_skips_corrupt(tmp_path):
    tree, mgr = _two_saves(tmp_path)
    f = tmp_path / "step_000000002" / "leaf_00000.npy"
    data = bytearray(f.read_bytes())
    data[-1] ^= 0xFF
    f.write_bytes(bytes(data))
    step, out = mgr.restore_latest(tree)
    assert step == 1
    _equal_trees(tree, out)


def test_truncated_leaf_detected_before_load(tmp_path):
    tree = _tree()
    checkpointer.save(str(tmp_path), 3, tree)
    faults.truncate_checkpoint(str(tmp_path / "step_000000003"),
                               keep_bytes=16)
    with pytest.raises(IOError, match="truncated"):
        checkpointer.restore(str(tmp_path / "step_000000003"), tree)


@pytest.mark.parametrize("fault", [faults.truncate_checkpoint,
                                   faults.drop_checkpoint_file],
                         ids=["truncated", "dropped"])
def test_restore_latest_walks_back(tmp_path, fault):
    tree, mgr = _two_saves(tmp_path)
    fault(str(tmp_path / "step_000000002"))
    step, out = mgr.restore_latest(tree)
    assert step == 1
    _equal_trees(tree, out)


def test_all_checkpoints_corrupt_returns_none(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    mgr.save(1, tree)
    faults.truncate_checkpoint(str(tmp_path / "step_000000001"))
    step, out = mgr.restore_latest(tree)
    assert step is None
    assert out is tree


def test_manifest_promises_leaf_sizes(tmp_path):
    tree = _tree()
    checkpointer.save(str(tmp_path), 1, tree)
    with open(tmp_path / "step_000000001" / "manifest.json") as f:
        manifest = json.load(f)
    assert [m["dtype"] for m in manifest["leaves"]] == \
        ["float32", "int32", "bfloat16"]
    for meta in manifest["leaves"]:
        path = tmp_path / "step_000000001" / meta["file"]
        assert meta["nbytes"] == path.stat().st_size > 0


def test_async_save_then_wait(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(7, tree)
    mgr.wait()
    assert mgr.latest_step() == 7


def test_async_save_keeps_the_values_an_in_place_update_overwrites(tmp_path):
    """The port's AdamW writes params in place right after a save: the
    save copied every leaf to host memory before it returned."""
    tree = _tree()
    saved = {"a": tree["a"].clone(), "b": {"c": tree["b"]["c"].clone(),
                                           "d": tree["b"]["d"].clone()}}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(3, tree)
    with torch.no_grad():
        tree["a"].add_(1.0)
        tree["b"]["d"].mul_(-2)
    mgr.wait()
    _, out = mgr.restore_latest(tree)
    _equal_trees(saved, out)


def test_restore_builds_fresh_tensors_on_the_device_asked(tmp_path):
    tree = _tree()
    checkpointer.save(str(tmp_path), 1, tree)
    out = checkpointer.restore(str(tmp_path / "step_000000001"), tree,
                               device=torch.device("cpu"))
    for a, b in zip(checkpointer._flatten(tree), checkpointer._flatten(out)):
        assert a.untyped_storage().data_ptr() != \
            b.untyped_storage().data_ptr()
    with torch.no_grad():
        tree["a"].zero_()
    assert not torch.equal(out["a"], tree["a"])


def test_structure_drift_and_shape_drift_raise(tmp_path):
    tree = _tree()
    checkpointer.save(str(tmp_path), 1, tree)
    path = str(tmp_path / "step_000000001")
    with pytest.raises(ValueError, match="structure drift"):
        checkpointer.restore(path, {"a": tree["a"]})
    with pytest.raises(ValueError, match="shape"):
        checkpointer.restore(path, {**tree, "a": torch.zeros(3)})


# --------------------------------------------- across the two packages
@pytest.fixture(scope="module")
def lm_state():
    """The reduced TinyLlama's (params, AdamW state) after one nonzero
    moment update, in both packages: bf16 params, f32 moments, an int32
    step."""
    cfg = jreg.get_reduced(ARCH)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    ocfg = jadamw.AdamWConfig()
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jp)
    jp, jopt = jadamw.update(grads, jadamw.init(jp, ocfg), jp, ocfg)
    host = jax.tree.map(np.asarray, (jp, jopt))
    return (jp, jopt), (params_from_numpy(host[0], device="cpu"),
                        params_from_numpy(host[1], device="cpu"))


def _same_as_jax(tree, jtree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = checkpointer._flatten(tree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j).astype(np.float32))


def test_leaf_order_is_jax_tree_flatten_order(lm_state):
    (jp, jopt), (tp, topt) = lm_state
    assert isinstance(topt, adamw.AdamWState)
    _same_as_jax((tp, topt), (jp, jopt))
    assert checkpointer._flatten({"b": 1, "a": [2, None]}) == [2, 1]


def test_reference_checkpoint_restores_in_the_port(tmp_path, lm_state):
    (jp, jopt), (tp, topt) = lm_state
    jckpt.save(str(tmp_path), 4, (jp, jopt))
    target = (tlm.init_params(treg.get_reduced(ARCH), device="cpu"),)
    target = (target[0], adamw.init(target[0]))
    step, out = CheckpointManager(str(tmp_path)).restore_latest(
        target, torch.device("cpu"))
    assert step == 4
    _same_as_jax(out, (jp, jopt))
    assert isinstance(out[1], adamw.AdamWState)


def test_port_checkpoint_restores_in_the_reference(tmp_path, lm_state):
    (jp, jopt), (tp, topt) = lm_state
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(6, (tp, topt))
    mgr.wait()
    target = jax.tree.map(jnp.zeros_like, (jp, jopt))
    step, out = JManager(str(tmp_path)).restore_latest(target)
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves((jp, jopt))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32),
                                      np.asarray(b).astype(np.float32))
    names = sorted(os.listdir(tmp_path / "step_000000006"))
    assert names[-2:] == ["leaf_%05d.npy" % (len(names) - 3),
                          "manifest.json"] and "_COMMITTED" in names
