"""Elastic restart and the mesh-aware launchers of the port, on the CPU.

`shrunk_mesh` against `repro`'s; the elastic drill of `repro`'s
`tests/conftest.py` (`elastic_drill`: train on a (4, 2) mesh saving at
steps 3, 6 and 9, tear the newest snapshot, shrink to (2, 2), restore
walking back to step 6, and resume within rtol / atol 0.05 of the
healthy run) at its `drill` config on logical meshes; `Server(mesh=)` and
`train_loop(mesh=)` against their meshless runs at tinyllama-1.1b's
reduced size.
"""
import functools
import os

import numpy as np
import pytest
import torch

from repro.runtime import elastic as jelastic
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LMConfig, SpikingConfig
from repro_torch.data import synthetic
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.launch.serve import Request, Server
from repro_torch.models import lm
from repro_torch.optim import adamw, schedule as sched
from repro_torch.runtime import elastic, faults

torch.set_num_threads(1)
DRILL = LMConfig(name="drill", family="dense", n_layers=2, d_model=32,
                 n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                 spiking=SpikingConfig(t_steps=1), remat="none",
                 loss_chunk=16)
CPU = torch.device("cpu")


@pytest.mark.parametrize("old,failed", [
    ((4, 2), 2), ((8, 1), 3), ((16, 16), 1), ((2, 16, 16), 5), ((4, 2), 3)])
def test_shrunk_mesh_equals_repro(old, failed):
    axes = ("data", "model") if len(old) == 2 else ("pod", "data", "model")
    got = elastic.shrunk_mesh(old, axes, failed)
    want = jelastic.shrunk_mesh(old, axes, failed)
    assert (got.mesh_shape, got.axis_names, got.microbatch_scale) \
        == (want.mesh_shape, want.axis_names, want.microbatch_scale)


def test_shrunk_mesh_with_no_group_left_raises():
    with pytest.raises(RuntimeError, match="no healthy data groups"):
        elastic.shrunk_mesh((2, 2), ("data", "model"), 2)


def drill_loop(cfg, mesh, params, opt_state, batches, start, stop,
               mgr=None):
    """`repro`'s `_drill_loop`: the same global batches whatever the mesh,
    a warmup-cosine AdamW step resolved under `mesh`, a save after every
    `save_every`-th update (labelled with the updates taken)."""
    step_fn = steps_mod.make_train_step(
        cfg, adamw.AdamWConfig(lr=1e-2), functools.partial(
            sched.warmup_cosine, warmup_steps=2, total_steps=10),
        spiking=False, mesh=mesh)
    dev = mesh.distinct_devices()[0]
    losses = []
    for t in range(start, stop):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batches[t].items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if mgr and mgr.should_save(t + 1):
            mgr.save(t + 1, (params, opt_state))
    if mgr:
        mgr.wait()
    return params, opt_state, losses


def run_drill(tmp_dir, device=CPU):
    """The drill of `repro`'s `elastic_drill`; returns (restored step,
    healthy losses, resumed losses)."""
    batches = [synthetic.lm_batch(0, 0, t, 8, 16, DRILL.vocab)
               for t in range(10)]

    def fresh():
        params = lm.init_params(DRILL, seed=0, device=device)
        return params, adamw.init(params, adamw.AdamWConfig(lr=1e-2))
    mesh_a = make_mesh((4, 2), ("data", "model"), devices=device)
    mgr = CheckpointManager(tmp_dir, save_every=3)
    *_, healthy = drill_loop(DRILL, mesh_a, *fresh(), batches, 0, 10,
                             mgr=mgr)
    # Two of four data groups die, and the newest snapshot is torn with
    # them: recovery must not trust it.
    faults.truncate_checkpoint(os.path.join(tmp_dir, "step_000000009"))
    plan = elastic.shrunk_mesh((4, 2), ("data", "model"),
                               n_failed_data_groups=2)
    assert plan.mesh_shape == (2, 2) and plan.microbatch_scale == 2
    mesh_b = make_mesh(plan.mesh_shape, plan.axis_names, devices=device)
    step, (p, o) = elastic.reshard_restore(DRILL, mgr, fresh(), mesh_b)
    *_, resumed = drill_loop(DRILL, mesh_b, p, o, batches, step, 10)
    return step, healthy, resumed


def test_elastic_drill_walks_back_past_a_torn_snapshot(tmp_path):
    step, healthy, resumed = run_drill(str(tmp_path / "ck"))
    assert step == 6, step
    assert np.all(np.isfinite(resumed)) and len(resumed) == 4
    np.testing.assert_allclose(resumed, healthy[6:10], rtol=0.05, atol=0.05)


def test_reshard_restore_refuses_a_mesh_over_two_devices(tmp_path):
    """A one-process mesh over two devices raises, naming the rank mesh;
    a logical mesh on one device and a rank mesh (here the one rank of a
    `gloo` group) restore: every rank the same step, its own part."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    two = make_mesh((2, 1), ("data", "model"), devices=["cpu", "meta"])
    params = lm.init_params(DRILL, device="cpu")
    with pytest.raises(NotImplementedError, match="make_rank_mesh"):
        elastic.reshard_restore(DRILL, mgr, params, two)
    one = make_mesh((2, 1), ("data", "model"), devices="cpu")
    assert elastic.reshard_restore(DRILL, mgr, params, one) == (None,
                                                                params)
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_rank_mesh
    mgr.save(4, params)
    mgr.wait()
    with distributed.single_rank("gloo", "cpu"):
        ranks = make_rank_mesh((1, 1), ("data", "model"))
        step, got = elastic.reshard_restore(DRILL, mgr, params, ranks)
    assert step == 4
    for a, b in zip(adamw.leaves(got), adamw.leaves(params)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


# ----------------------------------------------------- mesh-aware launchers
def _serve(mesh, spiking):
    cfg = treg.get_reduced("tinyllama-1.1b")
    srv = Server(cfg, n_slots=4, max_seq=64, spiking=spiking, mesh=mesh,
                 device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
        0, cfg.vocab, 3 + 2 * i)], max_new=4) for i in range(4)]
    srv.submit(reqs[0])
    srv.submit(reqs[1])
    srv.step()
    srv.submit(reqs[2])
    srv.submit(reqs[3])
    srv.run_until_drained()
    assert all(r.state == "done" for r in reqs)
    return [r.generated for r in reqs]


@pytest.mark.parametrize("spiking", [True, False], ids=["spiking", "dense"])
def test_server_under_a_mesh_serves_the_meshless_tokens(spiking):
    """The mesh steers resolution only: a logical 8-position data mesh and
    the host mesh serve the meshless Server's tokens exactly."""
    want = _serve(None, spiking)
    assert _serve(make_mesh((8, 1), ("data", "model"), devices="cpu"),
                  spiking) == want
    assert _serve(make_host_mesh(device="cpu"), spiking) == want


def test_train_loop_on_the_host_mesh_gives_the_meshless_losses():
    cfg = treg.get_reduced("tinyllama-1.1b")
    kw = dict(steps=2, batch=2, seq=16, log_every=100, device="cpu")
    flat = ttrain.train_loop(cfg, **kw)
    on_mesh = ttrain.train_loop(cfg, mesh=make_host_mesh(device="cpu"), **kw)
    assert on_mesh["losses"] == flat["losses"]
    # a logical data mesh feeds shard 0's rows: batch // data each step
    two = ttrain.train_loop(cfg, mesh=make_mesh(
        (2, 1), ("data", "model"), devices="cpu"), **kw)
    assert len(two["losses"]) == 2 and np.all(np.isfinite(two["losses"]))


def test_train_loop_defaults_to_the_training_device_alone(monkeypatch):
    """On a host of two cards the default mesh is the training card's
    alone, so `train_loop(mesh=None)` trains where a mesh over both
    cards would be refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    for dev, want in ((torch.device("cuda"), torch.device("cuda", 1)),
                      (torch.device("cuda", 0), torch.device("cuda", 0)),
                      (torch.device("cpu"), torch.device("cpu"))):
        mesh = ttrain.training_mesh(dev)
        assert mesh.distinct_devices() == (want,) and mesh.size == 1
    assert len(make_host_mesh().distinct_devices()) == 2
    cfg = treg.get_reduced("tinyllama-1.1b")
    out = ttrain.train_loop(cfg, steps=2, batch=2, seq=16, log_every=100,
                            device="cpu")
    assert out["mesh"].distinct_devices() == (torch.device("cpu"),)
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
