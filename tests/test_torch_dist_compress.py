"""Gradient compression over rank meshes and the multi-pod mesh, across
`gloo` processes on the CPU, against the one-process `grad_compress` of
the gathered summed gradient and the JAX package's jitted compressed
train step on a host mesh of the same shape.

A small dense spiking LM (`CFG`: 2 layers, d 64, f32 leaves drawn from
a seed of their path, `test_torch_dist_moe.leaf_values`, so both
packages hold the same tree) takes STEPS compressed steps on the rank
meshes (2, 1) and (1, 2) (two ranks) and pure FSDP on (2, 2) (four),
each batch rank its rows of the same global batches.

Yardsticks:
  * losses within F32_TOL relative, and the final params within
    STEP_PARAM_TOL, of the reference's `make_train_step(
    grad_compression=True)` jitted with `param_specs` / `batch_specs`
    shardings on four host devices (the tolerances of
    `tests/test_torch_train_lm.py`'s compressed three steps);
  * at steps 0 and 1, every rank's wire, scales and error-feedback
    blocks gathered whole (`sharding.full_leaves`) bit for bit with
    `grad_compress.compress` run in one process on the gathered summed
    gradient and error-feedback state;
  * the multi-pod mesh: `make_production_mesh(multi_pod=True)` in a
    world of four is the (pod 2, data 2, model 1) mesh, and its
    compressed steps are bit for bit with the (4, 1) mesh's (the same
    batch ranks in the same order, pod-major): params, EF state and
    losses; `rank_rows` hands out pod-major rows; an odd world raises;
  * restore across a pod mesh: the (2, 2, 1) run's checkpoint restored
    by two ranks onto `elastic.shrunk_mesh`'s (2, 1, 1), which keeps
    `pod` and `model` and shrinks `data` as the reference's does, leaf
    for leaf the saved tree.

Every spawn joins its ranks within SPAWN_TIMEOUT seconds; the ranks
import this module and never JAX.
"""
import hashlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import LMConfig, SpikingConfig
from repro_torch.data import synthetic
from repro_torch.launch import distributed
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import RankMesh, make_production_mesh, \
    make_rank_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw, grad_compress
from repro_torch.runtime import elastic, sharding
from test_torch_dist_moe import leaf_values

torch.set_num_threads(1)
SPAWN_TIMEOUT = 120
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = dict(name="compress-tiny", family="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, remat="none",
              loss_chunk=16)
CFG = LMConfig(spiking=SpikingConfig(t_steps=2), **FIELDS)
BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3
F32_TOL = 1e-5
STEP_PARAM_TOL = 2e-4
AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
# (world, mesh shape, pure_fsdp) of the runs held to the reference
RUNS = ((2, (2, 1), False), (2, (1, 2), False), (4, (2, 2), True))


def config(pure_fsdp: bool) -> LMConfig:
    return CFG.replace(pure_fsdp=pure_fsdp)


def tree_of(cfg):
    """The whole f32 tree of `leaf_values`."""
    return sharding._map_with_path(
        lambda p, x: torch.from_numpy(leaf_values("/".join(p), x.shape)),
        lm.abstract_params(cfg))


def batches(cfg) -> list:
    return [synthetic.lm_batch(0, 0, t, BATCH, SEQ, cfg.vocab)
            for t in range(STEPS)]


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().float().contiguous().numpy()
                          .tobytes()).hexdigest()


def digests(tree) -> list:
    return [digest(t) for t in adamw.leaves(tree)]


def compressed_run(cfg, mesh, record: bool = False) -> dict:
    """STEPS compressed steps on this rank of `mesh` from the whole tree's
    `local_params`, each batch rank its `rank_rows`. With `record`, each
    of the first two steps' compression inputs and outputs gathered whole
    (rank 0 keeps them). Returns the losses, grad norms, the local params
    and EF state, and the state for a checkpoint."""
    whole = tree_of(cfg)
    specs = sharding.param_specs(cfg, whole, mesh)
    params = sharding.local_params(whole, specs, mesh)
    opt_cfg = adamw.AdamWConfig(lr=LR)
    opt = adamw.init(params, opt_cfg)
    ef = grad_compress.init(params)
    step = steps_mod.make_train_step(cfg, opt_cfg, spiking=True,
                                     grad_compression=True, mesh=mesh)
    seen, orig = [], grad_compress.compress

    def compress(grads, ef_state, whole_max=None):
        wire, scales, new = orig(grads, ef_state, whole_max)
        if record and len(seen) < 2:
            seen.append(tuple(
                adamw.unflatten(grads, [t.detach().clone()
                                        for t in adamw.leaves(x)])
                for x in (grads, ef_state.error, wire, new.error)) +
                ([float(s) for s in adamw.leaves(scales)],))
        return wire, scales, new

    losses, norms = [], []
    grad_compress.compress = compress
    try:
        for b in batches(cfg):
            rows = ttrain.rank_rows(BATCH, mesh, cfg.pure_fsdp)
            batch = {k: torch.as_tensor(v[rows]) for k, v in b.items()}
            params, opt, ef, metrics = step(params, opt, ef, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    finally:
        grad_compress.compress = orig
    out = {"losses": losses, "norms": norms, "params": params, "ef": ef,
           "opt": opt, "specs": specs, "whole": whole}
    if record:
        gathered = []
        for *trees, scales in seen:
            full = [[t.detach().float().numpy()
                     for t in sharding.full_leaves(tr, specs, mesh)]
                    for tr in trees]
            gathered.append(full + [scales])
        out["compress"] = gathered
        out["final"] = [t.detach().numpy() for t in sharding.full_leaves(
            params, specs, mesh)]
    return out


# ------------------------------------------------------------ rank bodies
def world(world_size: int, ck_dir: str) -> dict:
    """This rank's runs: the reference's meshes of `world_size` ranks, and
    in a world of four the multi-pod mesh beside (4, 1) and its
    checkpoint."""
    torch.set_num_threads(1)
    out = {}
    for n, shape, pure in RUNS:
        if n != world_size:
            continue
        run = compressed_run(config(pure), make_rank_mesh(shape, AXES),
                             record=True)
        mine = {k: run[k] for k in ("losses", "norms")}
        if distributed.rank() == 0:
            mine.update(compress=run["compress"], final=run["final"])
        out[shape] = mine
    if world_size == 4:
        pod = make_production_mesh(multi_pod=True)
        flat = make_rank_mesh((4, 1), AXES)
        runs = {"pod": compressed_run(CFG, pod),
                "flat": compressed_run(CFG, flat)}
        out["multi_pod"] = {
            "shape": tuple(pod.shape.items()), "coords": pod.coords(),
            **{k: {"losses": r["losses"], "params": digests(r["params"]),
                   "ef": digests(r["ef"].error)} for k, r in runs.items()}}
        r = runs["pod"]
        mgr = CheckpointManager(ck_dir, save_every=1, writer=pod.rank == 0)
        mgr.save(STEPS, leaves=sharding.full_leaves(
            (r["params"], r["opt"]), sharding.state_specs(r["specs"]), pod))
        mgr.wait()
        distributed.barrier()
        out["saved"] = digests(tuple(sharding.full_leaves(
            r["params"], r["specs"], pod)))
    return out


def restore_world(ck_dir: str) -> dict:
    """Two ranks left of the (2, 2, 1) pod mesh: the shrunk mesh restores
    its checkpoint; the restored params gathered whole."""
    torch.set_num_threads(1)
    plan = elastic.shrunk_mesh((2, 2, 1), POD_AXES, n_failed_data_groups=1)
    mesh = make_rank_mesh(plan.mesh_shape, plan.axis_names)
    mgr = CheckpointManager(ck_dir, save_every=1, writer=mesh.rank == 0)
    whole = lm.abstract_params(CFG)
    target = (whole, adamw.init(whole, adamw.AdamWConfig(lr=LR)))
    step, (params, _) = elastic.reshard_restore(CFG, mgr, target, mesh)
    specs = sharding.param_specs(CFG, whole, mesh)
    return {"step": step, "plan": (plan.mesh_shape, plan.microbatch_scale),
            "restored": digests(tuple(sharding.full_leaves(params, specs,
                                                           mesh)))}


# ---------------------------------------------------------------- the JAX
JAX_REFERENCE = textwrap.dedent("""
    import os, sys, zlib
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0")
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs.base import LMConfig, SpikingConfig
    from repro.data import synthetic
    from repro.launch import steps
    from repro.launch.mesh import make_mesh, use_concrete_mesh
    from repro.models import lm
    from repro.optim import adamw, grad_compress
    from repro.runtime import sharding
    fields, runs, std, batch, seq, n_steps, lr = eval(sys.argv[2])
    out = {}

    def tree_of(cfg):
        def leaf(kp, x):
            path = "/".join(sharding._path_str(kp))
            rng = np.random.default_rng(zlib.crc32(path.encode()))
            v = std * rng.standard_normal(x.shape)
            v = v if len(x.shape) > 1 + path.startswith("blocks") \\
                else 1.0 + v
            return jnp.asarray(v.astype(np.float32))
        return jax.tree_util.tree_map_with_path(leaf, lm.abstract_params(cfg))

    for shape, pure in runs:
        cfg = LMConfig(spiking=SpikingConfig(t_steps=2), pure_fsdp=pure,
                       **fields)
        mesh = make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:shape[0] * shape[1]])
        params = tree_of(cfg)
        pshard = jax.tree.map(lambda s: NamedSharding(mesh, s),
                              sharding.param_specs(cfg, params, mesh))
        opt_cfg = adamw.AdamWConfig(lr=lr)
        key = f"{shape[0]}x{shape[1]}"
        with mesh, use_concrete_mesh(mesh):
            params = jax.device_put(params, pshard)
            state = (params, adamw.init(params, opt_cfg),
                     grad_compress.init(params))
            step = jax.jit(steps.make_train_step(
                cfg, opt_cfg, spiking=True, grad_compression=True))
            for t in range(n_steps):
                b = {k: jnp.asarray(v) for k, v in synthetic.lm_batch(
                    0, 0, t, batch, seq, cfg.vocab).items()}
                bshard = {k: NamedSharding(mesh, s) for k, s in
                          sharding.batch_specs(cfg, b, mesh).items()}
                *state, metrics = step(*state, jax.device_put(b, bshard))
                out[f"{key}|loss{t}"] = np.asarray(metrics["loss"])
                out[f"{key}|norm{t}"] = np.asarray(metrics["grad_norm"])
        for i, p in enumerate(jax.tree.leaves(state[0])):
            out[f"{key}|{i}"] = np.asarray(p, np.float32)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """The worlds of two and four ranks, then the two-rank restore of the
    four's pod checkpoint, beside the reference's steps in a subprocess
    on four host devices."""
    from test_torch_dist_moe import LEAF_STD
    tmp = tmp_path_factory.mktemp("compress")
    ck_dir, out = str(tmp / "ckpt"), str(tmp / "jax.npz")
    spec = (FIELDS, [(shape, pure) for _, shape, pure in RUNS], LEAF_STD,
            BATCH, SEQ, STEPS, LR)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_REFERENCE, out, repr(spec)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        worlds = {n: distributed.spawn(world, n, backend="gloo",
                                       device="cpu", timeout_s=SPAWN_TIMEOUT,
                                       args=(n, ck_dir))
                  for n in (2, 4)}
        restored = distributed.spawn(restore_world, 2, backend="gloo",
                                     device="cpu", timeout_s=SPAWN_TIMEOUT,
                                     args=(ck_dir,))
        log, _ = jax_run.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, log[-3000:]
    return {"worlds": worlds, "restored": restored,
            "jax": dict(np.load(out))}


def run_id(run) -> str:
    n, shape, pure = run
    return f"{shape[0]}x{shape[1]}{'-pure_fsdp' if pure else ''}"


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("run", RUNS, ids=run_id)
def test_compressed_steps_match_the_reference_jitted_step(ranked, run):
    n, shape, pure = run
    jax_ref = ranked["jax"]
    key = f"{shape[0]}x{shape[1]}"
    ranks = ranked["worlds"][n]
    want = [float(jax_ref[f"{key}|loss{t}"]) for t in range(STEPS)]
    for r in ranks:
        np.testing.assert_allclose(r[shape]["losses"], want, rtol=F32_TOL)
        np.testing.assert_allclose(
            r[shape]["norms"], [float(jax_ref[f"{key}|norm{t}"])
                                for t in range(STEPS)], rtol=F32_TOL)
    for i, p in enumerate(ranks[0][shape]["final"]):
        np.testing.assert_allclose(p, jax_ref[f"{key}|{i}"], rtol=0,
                                   atol=STEP_PARAM_TOL)


@pytest.mark.parametrize("run", RUNS, ids=run_id)
def test_wire_scales_and_ef_are_one_process_compress_of_the_sum(ranked,
                                                                run):
    n, shape, pure = run
    rec = ranked["worlds"][n][0][shape]["compress"]
    assert len(rec) == 2             # steps 0 and 1: the EF carried once
    whole = lm.abstract_params(config(pure))
    for grads, ef_in, wire, ef_out, scales in rec:
        g = adamw.unflatten(whole, [torch.from_numpy(x) for x in grads])
        e = adamw.unflatten(whole, [torch.from_numpy(x) for x in ef_in])
        w1, s1, e1 = grad_compress.compress(g, grad_compress.EFState(e))
        for got, want in zip(wire, adamw.leaves(w1)):
            assert np.array_equal(got, want.float().numpy())
        assert scales == [float(s) for s in adamw.leaves(s1)]
        for got, want in zip(ef_out, adamw.leaves(e1.error)):
            assert np.array_equal(got, want.float().numpy())
    # the EF state carried into step 1 is step 0's
    for a, b in zip(rec[0][3], rec[1][1]):
        assert np.array_equal(a, b)


def test_multi_pod_mesh_steps_equal_the_flat_mesh_steps(ranked):
    ranks = ranked["worlds"][4]
    for r in ranks:
        mp = r["multi_pod"]
        assert dict(mp["shape"]) == {"pod": 2, "data": 2, "model": 1}
        assert mp["pod"]["losses"] == mp["flat"]["losses"]
        assert mp["pod"]["params"] == mp["flat"]["params"]
        assert mp["pod"]["ef"] == mp["flat"]["ef"]
    losses = {tuple(r["multi_pod"]["pod"]["losses"]) for r in ranks}
    assert len(losses) == 1
    assert [(r["multi_pod"]["coords"]["pod"], r["multi_pod"]["coords"]
             ["data"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_shrunk_pod_mesh_restores_the_checkpoint(ranked):
    from repro.runtime import elastic as jelastic
    saved = ranked["worlds"][4][0]["saved"]
    want = jelastic.shrunk_mesh((2, 2, 1), POD_AXES, 1)
    for r in ranked["restored"]:
        assert r["step"] == STEPS
        assert r["plan"] == (tuple(want.mesh_shape), want.microbatch_scale)
        assert r["plan"][0] == (2, 1, 1)
        assert r["restored"] == saved


@pytest.mark.parametrize("pure_fsdp", [False, True])
def test_rank_rows_run_pod_major(pure_fsdp):
    """On (pod 2, data 2, model 2) each batch rank's rows follow its
    (pod, data[, model]) index row-major: pod 0's ranks hold the first
    half of the step's rows."""
    shape, rows = (2, 2, 2), 16
    n = 8 if pure_fsdp else 4
    for rank in range(8):
        mesh = RankMesh(shape, POD_AXES, rank, torch.device("cpu"), {})
        c = mesh.coords()
        idx = c["pod"] * 2 + c["data"]
        if pure_fsdp:
            idx = idx * 2 + c["model"]
        per = rows // n
        assert ttrain.rank_rows(rows, mesh, pure_fsdp) == \
            slice(idx * per, (idx + 1) * per)


def test_multi_pod_mesh_refuses_an_odd_world_and_no_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(multi_pod=True)
    with distributed.single_rank("gloo"):
        with pytest.raises(ValueError, match="odd"):
            make_production_mesh(multi_pod=True)
        mesh = make_production_mesh()
        assert mesh.shape == {"data": 1, "model": 1}


def test_step_compression_on_a_rank_mesh_no_longer_raises():
    """A one-rank group: the compressed step runs (its collectives run
    on one rank) and equals the meshless compressed step bit for bit."""
    b = {k: torch.as_tensor(v) for k, v in batches(CFG)[0].items()}
    outs = []
    with distributed.single_rank("gloo"):
        for mesh in (make_rank_mesh((1, 1), AXES), None):
            params = tree_of(CFG)
            opt_cfg = adamw.AdamWConfig(lr=LR)
            step = steps_mod.make_train_step(CFG, opt_cfg, spiking=True,
                                             grad_compression=True,
                                             mesh=mesh)
            p, _, ef, m = step(params, adamw.init(params, opt_cfg),
                               grad_compress.init(params), b)
            outs.append((float(m["loss"]), digests(p), digests(ef.error)))
    assert outs[0] == outs[1]
