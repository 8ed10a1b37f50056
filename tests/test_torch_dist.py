"""Ranks of a process group on the CPU: the port's data-parallel training,
expert-parallel MoE and elastic restore across `gloo` processes, against
the one-process runs and the JAX package.

Every spawn (`launch.distributed.spawn`) joins its ranks with a deadline
of SPAWN_TIMEOUT seconds, so a hung rank fails its test and not the
suite. Two worlds carry most of the checks, each spawned once by a
module fixture: two ranks ((1, 2) and (2, 1) rank meshes) and four ranks
((1, 4) and (2, 2)). JAX is imported in the test process alone, lazily:
the ranks import this module and never JAX.

Gates:
  * data-parallel losses within 1e-5 relative of the one-process
    logical-mesh `train_loop` over the same rows; the replicated params
    bit for bit across ranks after every step;
  * the EP MoE within 1e-5 of max|ref| of `repro`'s `moe_apply` (free
    capacity) and of `repro`'s `moe_apply_shard_map` on 4 host devices
    (binding capacity, data 2), run in a subprocess that writes an .npz;
  * EP gradients (input, router, expert banks) within 1e-5 relative L2
    of `jax.grad` of `moe_apply`;
  * the one-process logical-mesh form equal to the rank form bit for bit
    on 2 ranks;
  * the elastic drill across ranks (4 ranks on (2, 2), shrunk to 2 on
    (1, 2)) walks back to step 6 and tracks the healthy run within 0.05;
  * a checkpoint of split expert banks resumes the run bit for bit;
  * the MoE configs a rank mesh once refused train on it as the
    one-process run does, and `tp2d` is refused.
"""
import contextlib
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LMConfig, SpikingConfig
from repro_torch.data import synthetic
from repro_torch.launch import distributed
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh, make_rank_mesh
from repro_torch.models import lm, placement
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import params_from_numpy
from repro_torch.optim import adamw, schedule as sched
from repro_torch.runtime import elastic, faults, sharding

torch.set_num_threads(1)
SPAWN_TIMEOUT = 120
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRILL = LMConfig(name="drill", family="dense", n_layers=2, d_model=32,
                 n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                 spiking=SpikingConfig(t_steps=1), remat="none",
                 loss_chunk=16)
# The reduced qwen2-moe through the EP MoE, at its own T = 2 with its two
# shared experts (each rank routes the reference's data shard of the
# flattened global tokens, and the shared experts fire along all of them).
MOE = treg.get_reduced("qwen2-moe-a2.7b").replace(moe_shard_map=True)
# The configs a rank mesh refused before the MoE routed the global tokens
# (a T = 1 MoE with shared experts and a T = 2 one without, spiking over
# data ranks; `moe_apply` over data and model ranks; pure FSDP with an MoE
# over model ranks), each now trained on its mesh: key -> (config, mesh,
# spiking).
ONCE_REFUSED = {
    "spiking_shared": (MOE.replace(spiking=SpikingConfig(t_steps=1)),
                       (2, 2), None),
    "spiking_t2": (MOE.replace(moe=dataclasses.replace(MOE.moe, n_shared=0)),
                   (2, 2), None),
    "moe_apply_data": (MOE.replace(moe_shard_map=False), (2, 2), False),
    "moe_apply_model": (MOE.replace(moe_shard_map=False), (1, 4), False),
    "pure_fsdp_moe": (MOE.replace(pure_fsdp=True), (1, 4), False)}
TRAIN_KW = dict(steps=3, batch=8, seq=16, log_every=100)
# The reference's `shard_map_moe` case: d 32, d_ff 16 an expert, 8
# experts, top-2, x (4, 16, 32).
D, F, E, K = 32, 16, 8, 2
X_SHAPE = (4, 16, D)
FREE_CAPACITY, BINDING_CAPACITY = 8.0, 1.0
TOL = 1e-5
# Step-0 gradients of the data-parallel step against the one-process run,
# relative L2 per leaf. A bf16 leaf's gradient is rounded to bf16 on each
# rank and again when the ranks' parts are summed: within 2^-8 (the drill
# reads at most 3.1e-3). The MoE's bf16 gradients are summed over its
# data ranks the same way, and that rounding reaches every leaf upstream,
# its f32 norm scales and router too: within 2^-6 (the reduced qwen2-moe
# and its once-refused variants read at most 1.12e-2, pure FSDP on
# (1, 4); without pure FSDP on (1, 4), where only model ranks sum its f32
# partials, 4.1e-8). f32 leaves of the drill: TOL.
BF16_GRAD_TOL, MOE_GRAD_TOL = 2.0 ** -8, 2.0 ** -6
# Step 0's loss on a mesh with model ranks against the plain one-process
# run (not the witness), relative: the bf16 rounding of the row-split
# partials (at most 1.37e-3 read, the T = 1 MoE with shared experts on
# (2, 2)).
TP_PLAIN_LOSS_TOL = 2.0 ** -8
MODEL_AXES = ("data", "model")


# ------------------------------------------------------------ rank bodies
def _digests(tree) -> list:
    return [hashlib.sha256(t.detach().contiguous().view(torch.uint8)
                           .numpy().tobytes()).hexdigest()
            for t in adamw.leaves(tree)]


def _local_moe(moe_np, mesh):
    """The MoE params from numpy, this rank's expert slice kept."""
    p = params_from_numpy(moe_np, device="cpu")
    bank = sharding.P("model", None, None)
    specs = {"moe": {"router": sharding.P(None, None), "w_gate": bank,
                     "w_up": bank, "w_down": bank}}
    return sharding.local_params({"moe": p}, specs, mesh)["moe"]


def _ep_forward(moe_np, x, mesh, capacity_factor):
    p = _local_moe(moe_np, mesh)
    with torch.no_grad():
        return tmoe.moe_apply_shard_map(
            p, torch.from_numpy(x), top_k=K,
            capacity_factor=capacity_factor, mesh=mesh).numpy()


def _ep_grads(moe_np, x, cot, mesh) -> list:
    """d/d(x, router, w_gate, w_up, w_down) of sum(out * cot): x's and the
    router's whole, the banks' this rank's rows."""
    p = _local_moe(moe_np, mesh)
    leaves = [p[k] for k in ("router", "w_gate", "w_up", "w_down")]
    for t in leaves:
        t.requires_grad_(True)
    xg = torch.from_numpy(x).requires_grad_(True)
    out = tmoe.moe_apply_shard_map(p, xg, top_k=K,
                                   capacity_factor=FREE_CAPACITY, mesh=mesh)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [xg] + leaves)
    return [g.numpy() for g in grads]


def _dp_train(cfg, mesh, spiking=None) -> dict:
    """`train_loop` over the rank mesh; each step's leaf digests, and
    which leaves are this rank's own slice."""
    digests, orig = [], steps_mod.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)

        def recorded(params, opt_state, batch):
            out = step(params, opt_state, batch)
            digests.append(_digests(out[0]))
            return out
        return recorded

    steps_mod.make_train_step = make
    try:
        with first_grads() as grads:
            out = ttrain.train_loop(cfg, mesh=mesh, device="cpu",
                                    spiking=spiking, **TRAIN_KW)
    finally:
        steps_mod.make_train_step = orig
    params, whole = out["params"], lm.abstract_params(cfg)
    specs = sharding.param_specs(cfg, whole, mesh)
    sliced = sharding.sliced_leaves(whole, specs, mesh)
    banks = adamw.leaves(sharding._zip_specs(
        lambda path, leaf, spec: sharding._bank_dim(path, spec) is not None,
        whole, specs))
    # per leaf, the (dim, start, size) rows of the blocks of its whole
    # value this rank holds (`local_params`' cut)
    blocks = adamw.leaves(sharding._zip_specs(
        lambda path, leaf, spec: np.array([
            (d, sharding.shard_index(mesh, axes) * (leaf.shape[d] // k),
             leaf.shape[d] // k)
            for d, axes, k in sharding.splits(spec, mesh)],
            dtype=np.int64).reshape(-1, 3), whole, specs))
    return {"losses": out["losses"], "digests": digests, "sliced": sliced,
            "grads": grads, "blocks": blocks,
            "banks": [tuple(t.shape) for t, b in
                      zip(adamw.leaves(params), banks) if b]}


@contextlib.contextmanager
def first_grads():
    """While active, the gradients (f32 numpy, `adamw.leaves` order) of
    the first `adamw.update` call."""
    orig, got = adamw.update, []

    def update(grads, *a, **k):
        if not got:
            got.extend(g.detach().float().numpy().copy()
                       for g in adamw.leaves(grads))
        return orig(grads, *a, **k)

    adamw.update = update
    try:
        yield got
    finally:
        adamw.update = orig


def drill_loop(cfg, mesh, params, opt_state, batches, start, stop, mgr=None):
    """`repro`'s `_drill_loop` on a rank mesh: the same global batches
    whatever the mesh (each data rank its slice of the rows), a
    warmup-cosine AdamW step, a save after every `save_every`-th update
    (rank 0 writes the gathered tree, the ranks meet after it)."""
    step_fn = steps_mod.make_train_step(
        cfg, adamw.AdamWConfig(lr=1e-2), functools.partial(
            sched.warmup_cosine, warmup_steps=2, total_steps=10),
        spiking=False, mesh=mesh)
    whole = lm.abstract_params(cfg)
    specs = sharding.state_specs(sharding.param_specs(cfg, whole, mesh))
    losses = []
    for t in range(start, stop):
        rows = ttrain.rank_rows(batches[t]["tokens"].shape[0], mesh)
        batch = {k: torch.as_tensor(v[rows]) for k, v in batches[t].items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if mgr and mgr.should_save(t + 1):
            mgr.save(t + 1, leaves=sharding.full_leaves(
                (params, opt_state), specs, mesh))
            mgr.wait()
            distributed.barrier()
    return params, opt_state, losses


def _drill_batches():
    return [synthetic.lm_batch(0, 0, t, 8, 16, DRILL.vocab)
            for t in range(10)]


def _drill_fresh():
    params = lm.init_params(DRILL, seed=0, device="cpu")
    return params, adamw.init(params, adamw.AdamWConfig(lr=1e-2))


def _drill_healthy(mesh, ck_dir) -> list:
    mgr = CheckpointManager(ck_dir, save_every=3,
                            writer=mesh.rank == 0)
    whole = lm.abstract_params(DRILL)
    specs = sharding.state_specs(sharding.param_specs(DRILL, whole, mesh))
    state = sharding.local_params(_drill_fresh(), specs, mesh)
    *_, losses = drill_loop(DRILL, mesh, *state, _drill_batches(),
                            0, 10, mgr=mgr)
    return losses


def _drill_resume(ck_dir) -> dict:
    """Two of four ranks are gone: the (1, 2) mesh restores the newest
    valid snapshot and trains on from it."""
    torch.set_num_threads(1)
    plan = elastic.shrunk_mesh((2, 2), MODEL_AXES, n_failed_data_groups=1)
    mesh = make_rank_mesh(plan.mesh_shape, plan.axis_names)
    mgr = CheckpointManager(ck_dir, save_every=3, writer=mesh.rank == 0)
    step, (p, o) = elastic.reshard_restore(DRILL, mgr, _drill_fresh(), mesh)
    *_, losses = drill_loop(DRILL, mesh, p, o, _drill_batches(), step, 10)
    return {"step": step, "losses": losses, "shape": plan.mesh_shape}


def _resumed_run(cfg, mesh, ck_dir) -> dict:
    """`train_loop` over the rank mesh saving at steps 2 and 3 (rank 0
    writes each leaf as the ranks gather it), then, with step 3's
    snapshot gone, a resume from step 2 (each leaf cut to the rank's part
    as it is read) that takes step 2 again."""
    kw = dict(TRAIN_KW, ckpt_dir=ck_dir, save_every=2)
    whole = ttrain.train_loop(cfg, mesh=mesh, device="cpu", spiking=False,
                              **kw)
    if mesh.rank == 0:
        shutil.rmtree(os.path.join(ck_dir, "step_000000003"))
    distributed.barrier()
    again = ttrain.train_loop(cfg, mesh=mesh, device="cpu", spiking=False,
                              resume=True, **kw)
    return {"losses": whole["losses"], "resumed": again["losses"],
            "params": _digests(whole["params"]),
            "resumed_params": _digests(again["params"])}


def _refusal(cfg, mesh, spiking):
    """The message `train_loop` over `mesh` refuses `cfg` with, or None."""
    try:
        ttrain.train_loop(cfg, mesh=mesh, device="cpu", spiking=spiking,
                          **TRAIN_KW)
    except NotImplementedError as e:
        return str(e)
    return None


def _two_ranks(moe_np, x, cot, ck_dir) -> dict:
    torch.set_num_threads(1)
    ep = make_rank_mesh((1, 2), MODEL_AXES)
    out = {"j": ep.coords()["model"],
           "ep": _ep_forward(moe_np, x, ep, FREE_CAPACITY),
           "grads": _ep_grads(moe_np, x, cot, ep)}
    out["dp"] = _dp_train(DRILL, make_rank_mesh((2, 1), MODEL_AXES))
    out["ckpt"] = _resumed_run(MOE, ep, ck_dir)
    return out


def _four_ranks(moe_np, x, ck_dir) -> dict:
    torch.set_num_threads(1)
    ep = make_rank_mesh((1, 4), MODEL_AXES)
    out = {"j": ep.coords()["model"],
           "ep": _ep_forward(moe_np, x, ep, FREE_CAPACITY)}
    mesh = make_rank_mesh((2, 2), MODEL_AXES)
    c = mesh.coords()["data"]
    rows = X_SHAPE[0] // 2
    out["coords"] = (c, mesh.coords()["model"])
    out["drops"] = _ep_forward(moe_np, x[c * rows:(c + 1) * rows], mesh,
                               BINDING_CAPACITY)
    out["dp"] = _dp_train(DRILL, mesh)
    out["dp_moe"] = _dp_train(MOE, mesh, spiking=False)
    out["ep_moe"] = _dp_train(MOE, ep)
    out["healthy"] = _drill_healthy(mesh, ck_dir)
    out["once_refused"] = {
        key: _dp_train(cfg, mesh if shape == (2, 2) else ep, spiking)
        for key, (cfg, shape, spiking) in ONCE_REFUSED.items()}
    out["refused"] = {"tp2d": _refusal(DRILL.replace(tp2d=True), mesh,
                                       False)}
    return out


def _raise_on_rank1():
    if distributed.rank() == 1:
        raise ValueError("rank one fails")
    distributed.barrier()          # its peer never comes: spawn must end it
    return "unreachable"


def _hang_on_rank1():
    if distributed.rank() == 1:
        time.sleep(3600)
    return distributed.rank()


# ---------------------------------------------------------------- fixtures
JAX_SHARD_MAP = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0")
    import numpy as np, jax, jax.numpy as jnp
    from repro.launch.mesh import make_mesh, use_concrete_mesh
    from repro.models import moe
    d = np.load(sys.argv[1])
    p = {k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_up",
                                        "w_down")}
    x = jnp.asarray(d["x"])
    mesh = make_mesh((2, 2), ("data", "model"))
    with mesh, use_concrete_mesh(mesh):
        out = jax.jit(lambda pp, xx: moe.moe_apply_shard_map(
            pp, xx, top_k=%(k)d, capacity_factor=%(binding)r))(p, x)

    # The reference's own EP gradient (check_vma=False) against
    # moe_apply's, at free capacity on (1, 4) and (2, 2) meshes.
    def loss(fn, pp, xx):
        return jnp.sum(jnp.sin(fn(pp, xx, top_k=%(k)d,
                                  capacity_factor=%(free)r)))
    want = jax.grad(lambda pp, xx: loss(moe.moe_apply, pp, xx),
                    argnums=(0, 1))(p, x)
    gaps = []
    for shape in ((1, 4), (2, 2)):
        mesh = make_mesh(shape, ("data", "model"))
        with mesh, use_concrete_mesh(mesh):
            got = jax.jit(jax.grad(lambda pp, xx: loss(
                moe.moe_apply_shard_map, pp, xx), argnums=(0, 1)))(p, x)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            a, b = np.asarray(a), np.asarray(b)
            gaps.append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    np.savez(sys.argv[2], out=np.asarray(out), grad_gaps=np.asarray(gaps))
""" % dict(k=K, binding=BINDING_CAPACITY, free=FREE_CAPACITY))


@pytest.fixture(scope="module")
def moe_case():
    """The reference's MoE params (f32), the input and a cotangent, all
    numpy; `repro`'s `moe_apply` output and gradients on them."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jmoe.moe_init(
        jax.random.PRNGKey(0), D, F, n_experts=E))
    p = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    cot = rng.standard_normal(X_SHAPE).astype(np.float32)

    def loss(pp, xx):
        return jnp.sum(jmoe.moe_apply(pp, xx, top_k=K,
                                      capacity_factor=FREE_CAPACITY) * cot)
    ref = np.asarray(jmoe.moe_apply(jp, jnp.asarray(x), top_k=K,
                                    capacity_factor=FREE_CAPACITY))
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    grads = [np.asarray(gx)] + [np.asarray(gp[k]) for k in
                                ("router", "w_gate", "w_up", "w_down")]
    return dict(p=p, x=x, cot=cot, ref=ref, grads=grads)


@pytest.fixture(scope="module")
def two_ranks(moe_case, tmp_path_factory):
    ck_dir = str(tmp_path_factory.mktemp("dist2") / "ck")
    return distributed.spawn(_two_ranks, 2, backend="gloo", device="cpu",
                             timeout_s=SPAWN_TIMEOUT, args=(
                                 moe_case["p"], moe_case["x"],
                                 moe_case["cot"], ck_dir))


@pytest.fixture(scope="module")
def four_ranks(moe_case, tmp_path_factory):
    """The 4-rank world, with `repro`'s shard_map run beside it in a
    subprocess on 4 host devices (binding capacity)."""
    tmp = tmp_path_factory.mktemp("dist")
    inputs, jax_out = str(tmp / "moe_in.npz"), str(tmp / "moe_out.npz")
    np.savez(inputs, x=moe_case["x"], **moe_case["p"])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SHARD_MAP, inputs, jax_out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ck_dir = str(tmp / "ck")
        ranks = distributed.spawn(_four_ranks, 4, backend="gloo",
                                  device="cpu", timeout_s=SPAWN_TIMEOUT,
                                  args=(moe_case["p"], moe_case["x"],
                                        ck_dir))
        log, _ = jax_run.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, log
    ref = np.load(jax_out)
    return dict(ranks=ranks, jax_shard_map=ref["out"],
                jax_grad_gaps=ref["grad_gaps"], ck_dir=ck_dir)


def _one_process(cfg, shape, spiking, witness=False):
    """The one-process logical-mesh run: (losses, step-0 gradients). With
    `witness`, its tensor-parallel products run per model position and
    their partials are summed in position order (`placement.witness`),
    as the ranks' all-reduce sums them."""
    mesh = make_mesh(shape, MODEL_AXES, devices="cpu")
    with first_grads() as grads, \
            placement.witness() if witness else contextlib.nullcontext():
        out = ttrain.train_loop(cfg, mesh=mesh, device="cpu",
                                spiking=spiking, **TRAIN_KW)
    return out["losses"], grads


def _check_dp(ranks, cfg, shape, spiking=None, steps=None):
    """Losses within TOL of the one-process run (the first `steps`, all by
    default; on a mesh with model ranks, of its `witness` form, the plain
    run holding step 0's loss within TP_PLAIN_LOSS_TOL), step-0 gradients
    within TOL relative L2 per leaf (a cut leaf joined whole from the
    ranks' `local_params` blocks of it, every block held by each rank of
    its coordinates), replicated leaves bit for bit across ranks after
    every step."""
    want, want_grads = _one_process(cfg, shape, spiking)
    if shape[1] > 1:
        # The ranks run attention, the MLPs and the MoE's combine tensor-
        # or expert-parallel: each row-split product's partials round to
        # bf16 before the all-reduce sums them, which the plain run's
        # whole products do not, and its losses part from theirs by up to
        # 1.37e-3 relative at step 0 (the T = 1 MoE with shared experts
        # on (2, 2)).
        # The plain run holds their step-0 loss within TP_PLAIN_LOSS_TOL;
        # the witness, the same partials summed on one process, is the
        # reference of every check below.
        for r in ranks:
            assert abs(r["losses"][0] - want[0]) <= \
                TP_PLAIN_LOSS_TOL * abs(want[0]), (r["losses"][0], want[0])
        want, want_grads = _one_process(cfg, shape, spiking, witness=True)
    kinds = [t.dtype for t in adamw.leaves(lm.abstract_params(cfg))]
    steps = steps or len(want)
    for r in ranks:
        np.testing.assert_allclose(r["losses"][:steps], want[:steps],
                                   rtol=TOL, atol=0)
        assert len(r["digests"]) == TRAIN_KW["steps"]
    for i, w in enumerate(want_grads):
        g, seen = np.zeros_like(w), np.zeros(w.shape, dtype=bool)
        for r in ranks:
            at = [slice(None)] * w.ndim
            for dim, start, size in r["blocks"][i]:
                at[dim] = slice(start, start + size)
            block = g[tuple(at)]
            assert not seen[tuple(at)].any() or np.array_equal(
                block, r["grads"][i]), f"leaf {i}: a block differs " \
                f"across the ranks that hold it"
            g[tuple(at)], seen[tuple(at)] = r["grads"][i], True
        assert seen.all()
        tol = MOE_GRAD_TOL if cfg.moe is not None else \
            TOL if kinds[i] == torch.float32 else BF16_GRAD_TOL
        assert np.abs(w).max() == 0 or _rel_l2(g, w) <= tol, \
            f"leaf {i}: step-0 gradient {_rel_l2(g, w)} from the " \
            f"one-process run's"
    for step in range(TRAIN_KW["steps"]):
        for r in ranks[1:]:
            for i, (a, b) in enumerate(zip(ranks[0]["digests"][step],
                                           r["digests"][step])):
                if not (ranks[0]["sliced"][i] or r["sliced"][i]):
                    assert a == b, f"step {step}: replicated leaf {i} " \
                                   f"differs across ranks"


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -------------------------------------------------------------------- tests
def test_data_parallel_training_on_two_data_ranks(two_ranks):
    _check_dp([r["dp"] for r in two_ranks], DRILL, (2, 1))


@pytest.mark.parametrize("case", ["drill", "moe_dense", "moe_ep"])
def test_data_parallel_training_on_four_ranks(four_ranks, case):
    """The drill config and the dense MoE on (2, 2), the spiking MoE on
    (1, 4): each rank holds its 1/model of every expert bank."""
    key, cfg, shape, spiking = {
        "drill": ("dp", DRILL, (2, 2), None),
        "moe_dense": ("dp_moe", MOE, (2, 2), False),
        "moe_ep": ("ep_moe", MOE, (1, 4), None)}[case]
    ranks = [r[key] for r in four_ranks["ranks"]]
    # The MoE's bf16 gradients sum over the ranks in `all_reduce`'s order,
    # not position order, so step 0 agrees to TOL and AdamW's first
    # update, lr * sign(g), parts the trajectories after it (gradients
    # near 0 flip).
    _check_dp(ranks, cfg, shape, spiking, steps=1 if cfg is MOE else None)
    if cfg is MOE:
        m = shape[1]
        whole = lm.abstract_params(MOE)
        specs = sharding.param_specs(MOE, whole, make_mesh(
            shape, MODEL_AXES, devices="cpu"))
        full = [tuple(t.shape) for t, b in zip(
            adamw.leaves(whole), adamw.leaves(sharding._zip_specs(
                lambda path, leaf, spec: sharding._bank_dim(path, spec)
                is not None, whole, specs))) if b]
        assert len(full) == 3 and all(
            r["banks"] == [(g, e // m) + tuple(rest) for g, e, *rest in full]
            for r in ranks)


@pytest.mark.parametrize("world", ["two", "four"])
def test_ep_forward_matches_repro_moe_apply(moe_case, two_ranks, four_ranks,
                                            world):
    ranks = two_ranks if world == "two" else four_ranks["ranks"]
    ref = moe_case["ref"]
    for r in ranks:
        assert r["ep"].shape == ref.shape
        np.testing.assert_allclose(r["ep"], ref, rtol=0,
                                   atol=TOL * np.abs(ref).max())


def test_ep_with_dropped_assignments_matches_repro_shard_map(moe_case,
                                                            four_ranks):
    want = four_ranks["jax_shard_map"]
    got = np.zeros_like(want)
    rows = X_SHAPE[0] // 2
    for r in four_ranks["ranks"]:
        c, _ = r["coords"]
        got[c * rows:(c + 1) * rows] = r["drops"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    # the capacity binds: each data shard drops assignments
    p = params_from_numpy(moe_case["p"], device="cpu")
    assert tmoe.dropped_assignments(
        p, torch.from_numpy(moe_case["x"]), top_k=K,
        capacity_factor=BINDING_CAPACITY, dispatch_groups=2) > 0


def test_ep_gradients_match_jax_grad_of_moe_apply(moe_case, two_ranks):
    want = moe_case["grads"]
    e_loc = E // 2
    for r in two_ranks:
        j = r["j"]
        for i, (g, w) in enumerate(zip(r["grads"], want)):
            w = w[j * e_loc:(j + 1) * e_loc] if i >= 2 else w
            assert g.shape == w.shape
            assert _rel_l2(g, w) <= TOL, f"grad {i} on model rank {j}"


def test_reference_shard_map_gradient_is_moe_applys(four_ranks):
    """`repro`'s own EP MoE under `jax.grad` (`check_vma=False`) gives
    `moe_apply`'s gradients (no psum-transpose scaling by the model
    size), so holding the port's EP gradients to `moe_apply`'s holds
    them to the reference's."""
    gaps = four_ranks["jax_grad_gaps"]
    assert len(gaps) == 2 * 5 and np.all(gaps <= TOL), gaps


def test_logical_mesh_form_equals_the_rank_form_on_two_ranks(moe_case,
                                                            two_ranks):
    mesh = make_mesh((1, 2), MODEL_AXES, devices="cpu")
    p = params_from_numpy(moe_case["p"], device="cpu")
    with torch.no_grad():
        want = tmoe.moe_apply_shard_map(
            p, torch.from_numpy(moe_case["x"]), top_k=K,
            capacity_factor=FREE_CAPACITY, mesh=mesh).numpy()
    for r in two_ranks:
        np.testing.assert_array_equal(r["ep"], want)


def test_elastic_drill_across_ranks_walks_back_past_a_torn_snapshot(
        four_ranks):
    healthy = four_ranks["ranks"][0]["healthy"]
    assert all(r["healthy"] == healthy for r in four_ranks["ranks"])
    ck_dir = four_ranks["ck_dir"]
    assert sorted(os.listdir(ck_dir)) == [
        "step_000000003", "step_000000006", "step_000000009"]
    faults.truncate_checkpoint(os.path.join(ck_dir, "step_000000009"))
    resumed = distributed.spawn(_drill_resume, 2, backend="gloo",
                                device="cpu", timeout_s=SPAWN_TIMEOUT,
                                args=(ck_dir,))
    for r in resumed:
        assert r["shape"] == (1, 2) and r["step"] == 6
        assert np.all(np.isfinite(r["losses"])) and len(r["losses"]) == 4
        np.testing.assert_allclose(r["losses"], healthy[6:10], rtol=0.05,
                                   atol=0.05)


def test_rank_checkpoint_resumes_the_run_with_split_expert_banks(
        two_ranks):
    """The MoE over (1, 2): rank 0 writes the gathered banks, and the
    resume from step 2 takes step 2 as the unbroken run did, bit for
    bit, with each rank's half of every bank."""
    for r in two_ranks:
        ck = r["ckpt"]
        assert ck["resumed"] == ck["losses"][2:]
        assert ck["resumed_params"] == ck["params"]
    assert two_ranks[0]["ckpt"]["params"] != two_ranks[1]["ckpt"]["params"]


@pytest.mark.parametrize("case, match", [
    ("tp2d", "tp2d .* is not placed on a rank mesh")])
def test_rank_mesh_refuses_an_moe_its_ranks_would_change(four_ranks, case,
                                                        match):
    """`tp2d` is refused on every rank, before any step. The MoE configs
    a rank mesh once refused here now train on it (the next test)."""
    for r in four_ranks["ranks"]:
        assert r["refused"][case] is not None, case
        assert re.search(match, r["refused"][case]), r["refused"][case]


@pytest.mark.parametrize("case", list(ONCE_REFUSED))
def test_rank_mesh_trains_the_moe_configs_it_once_refused(four_ranks, case):
    """The MoE configs a rank mesh once refused (their fires scan the
    flattened tokens, `moe_apply`'s dispatch spans the global rows, pure
    FSDP puts the batch on model ranks) train on it as the one-process
    run does (`_check_dp`: step 0's loss and gradients, the replicated
    leaves across ranks)."""
    cfg, shape, spiking = ONCE_REFUSED[case]
    _check_dp([r["once_refused"][case] for r in four_ranks["ranks"]], cfg,
              shape, spiking, steps=1)


def test_nccl_without_a_card_raises_and_no_backend_is_switched():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nccl would start")
    with pytest.raises(RuntimeError, match="nccl backend needs a card"):
        distributed.init("nccl", "cpu", "tcp://127.0.0.1:1", rank=0,
                         world_size=1)
    assert not distributed.is_initialized()
    with pytest.raises(ValueError, match="backend must be one of"):
        distributed.spawn(_hang_on_rank1, 2, backend="mpi")


def test_spawn_raises_with_the_failing_ranks_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match=r"(?s)rank 1 of 2 failed.*rank one fails"):
        distributed.spawn(_raise_on_rank1, 2, backend="gloo",
                          timeout_s=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT


def test_spawn_ends_a_hung_rank_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after 12 s"):
        distributed.spawn(_hang_on_rank1, 2, backend="gloo", timeout_s=12)
    assert time.monotonic() - t0 < 12 + 30


STUB_NVCC = textwrap.dedent("""\
    #!%s
    import os, sys, time
    log = os.environ["STUB_NVCC_LOG"]
    with open(log, "a") as f:
        f.write(f"start {os.getpid()}\\n")
    time.sleep(0.5)
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(out, "w") as f:
        f.write("stub")
    with open(log, "a") as f:
        f.write(f"end {os.getpid()}\\n")
""" % sys.executable)

BUILD_CHILD = textwrap.dedent("""
    import os, sys, time
    from pathlib import Path
    from repro_torch.kernels import _build
    Path(sys.argv[2]).touch()                  # ready
    while not os.path.exists(sys.argv[3]):     # go
        time.sleep(0.01)
    print(_build.build(csrc=Path(sys.argv[1])), _build.BUILD_INFO["cached"])
""")


def test_two_processes_asking_for_one_build_take_turns(tmp_path):
    """Two processes build the same sources into one build directory at
    once, through a stub `nvcc` that logs each call: one compiles (two
    sources and a link, never overlapping), the other waits on the lock
    and loads its library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STUB_NVCC)
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=os.path.join(ROOT, "src"), STUB_NVCC_LOG=str(log),
               REPRO_TORCH_BUILD_DIR=str(tmp_path / "build"))
    go = tmp_path / "go"
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_CHILD, str(csrc),
         str(tmp_path / f"ready{i}"), str(go)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        deadline = time.monotonic() + SPAWN_TIMEOUT
        while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
            assert time.monotonic() < deadline, "build children never ready"
            assert all(p.poll() is None for p in procs), \
                [p.communicate()[0] for p in procs]
            time.sleep(0.05)
        go.touch()
        outs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.split()[-2] for o in outs}
    cached = sorted(o.split()[-1] for o in outs)
    assert len(paths) == 1 and cached == ["False", "True"], outs
    # One build: the two sources compiled together, then the link.
    calls = [c.split()[0] for c in log.read_text().split("\n")[:-1]]
    assert calls == ["start", "start", "end", "end", "start", "end"], calls
