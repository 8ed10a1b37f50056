"""The MoE configs on ranks of a process group as the registry configures
them: `moe_apply` over ranks, the reference's global token order for the
routing and the shared experts' fire, and pure FSDP with experts, across
`gloo` processes on the CPU, against the port's one-process run and the
JAX package's sharded step on a host mesh of the same shape.

This file holds the cases, the rank bodies and the checks, and runs the
two-rank world ((2, 1) and (1, 2) rank meshes);
`test_torch_dist_moe_4.py` runs the four-rank world ((2, 2) and (1, 4))
with the same checks, so that each file's spawn, one-process references
and JAX subprocess stay within about a minute. Every spawn joins its
ranks with a deadline of SPAWN_TIMEOUT seconds; the ranks import this
module and never JAX.

Cases (`CASES`): the reduced qwen2-moe as configured (T = 2, two shared
experts, `moe_apply`), again with `moe_shard_map=True` and with
`moe_dispatch_groups=2`; the reduced mixtral with `fsdp=True`; the
reduced jamba (an MoE every other layer); a six-expert qwen2-moe on
(1, 4), whose bank does not split over four model ranks, so each runs
its quarter of every expert's d_ff; and `pure_fsdp` with an MoE on (1, 2)
and (2, 2).

Yardsticks, each on every case and mesh:
  * routing: every routing call of the spiking prefill and decode (the
    top-k ids, the gate weights, the stable sort, `keep`, and so each
    layer's dropped assignments) equal to the one-process run's;
  * served tokens: the prefill logits and DECODE_STEPS greedy tokens of
    a pool of BATCH slots split over the batch ranks equal, bit for bit,
    to the one-process run's (`placement.witness` on a one-process mesh
    of the same shape: its tensor-parallel products per model position,
    the MoE on the global tokens as the ranks run it). The CPU's GEMMs
    give the same bits on any number of rows, so the data ranks' smaller
    products change nothing here;
  * the MoE layer alone (`lm._ffn` of the first MoE layer) on the same
    input, in f32 and bf16: bit for bit with the one-process witness,
    and where no shared experts run tensor-parallel, with the plain
    one-process `moe_apply` too;
  * training step 0 (bf16, spiking): on a mesh of model ranks alone,
    the loss and every gradient bit for bit with the witness (but for
    the expert-parallel form on four model ranks: see `exact`); where the
    ranks hold other rows (data ranks, pure FSDP), the loss within
    LOSS_GAP and every bf16 gradient within GRAD_GAP (relative L2 per
    leaf) of the one-process step: the loss's f32 sum runs over the
    ranks' parts, and each rank's bf16 gradient is rounded before the
    ranks' sum of it (the f32 step below is the witness of that cause);
    where batch ranks hold the rows of `moe_apply` (two data ranks, or
    pure FSDP's two and four), the loss and every gradient bit for bit
    with `parts_step`, the ranks' arithmetic on one process (each batch
    rank's forward in a thread, their MoE layers joined:
    `placement.witness_parts`), the witness of the bf16 gaps: the ranks'
    sums run in the wider type, rounded once, as the witness's do;
  * after two steps, every rank that holds a block of a leaf holds the
    same bits as the others that hold it;
  * `sharding.local_init` (each leaf cut as it is drawn) gives each rank
    its `local_params` of the seed's tree bit for bit;
  * the dense f32 step 0 from the same params on both sides: the loss
    within TOL relative and every gradient within TOL of max|ref| of the
    reference's `jax.value_and_grad(loss_fn)` jitted with `param_specs`
    and `batch_specs` shardings on four host devices (jamba within
    SSM_TOL: each scan step of its Mamba blocks rounds to bf16 whatever
    the params' dtype, so an f32 reduction's order moves a whole bf16
    step, ROADMAP queue 3 fact 9).
"""
import contextlib
import dataclasses
import functools
import hashlib
import os
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.data import synthetic
from repro_torch.launch import distributed
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import RankMesh, abstract_mesh, make_mesh, \
    make_rank_mesh, use_concrete_mesh
from repro_torch.models import lm, placement
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw
from repro_torch.runtime import sharding

torch.set_num_threads(1)
SPAWN_TIMEOUT = 240
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")
MESHES = ((2, 1), (1, 2), (2, 2), (1, 4))
# name -> (arch, overrides of its reduced config, rank meshes); a "moe"
# override replaces fields of the config's MoE spec
CASES = {
    "qwen": ("qwen2-moe-a2.7b", {}, MESHES),
    "qwen_shard_map": ("qwen2-moe-a2.7b", {"moe_shard_map": True}, MESHES),
    "qwen_groups2": ("qwen2-moe-a2.7b", {"moe_dispatch_groups": 2}, MESHES),
    "mixtral_fsdp": ("mixtral-8x22b", {"fsdp": True}, MESHES),
    "jamba": ("jamba-1.5-large-398b", {}, MESHES),
    "six_experts": ("qwen2-moe-a2.7b", {"moe": {"n_experts": 6}},
                    ((1, 4),)),
    "qwen_pure_fsdp": ("qwen2-moe-a2.7b", {"pure_fsdp": True},
                       ((1, 2), (2, 2))),
}
BATCH, SEQ, DECODE_STEPS = 4, 8, 3
TOL = 1e-5
SSM_TOL = 2.0 ** -8
LEAF_STD = 0.1
# Step 0 where the ranks hold other rows, against the one-process step:
# twice the worst readings over the cases here (the loss's relative gap
# read at most 1.4914e-7, jamba on (2, 1) and (2, 2); the worst bf16
# leaf's relative L2 gradient gap 6.9005e-3, qwen2-moe with pure FSDP on
# (2, 2)).
LOSS_GAP = 2 * 1.4914e-7
GRAD_GAP = 2 * 6.9005e-3


def config(name):
    arch, kw, _ = CASES[name]
    cfg = treg.get_reduced(arch)
    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = dataclasses.replace(cfg.moe, **kw["moe"])
    return cfg.replace(**kw)


def combos(world: int) -> list:
    """(case, mesh) of the meshes of `world` ranks."""
    return [(name, shape) for name, (_, _, shapes) in CASES.items()
            for shape in shapes if shape[0] * shape[1] == world]


def combo_id(combo) -> str:
    name, shape = combo
    return f"{name}-{shape[0]}x{shape[1]}"


def leaf_values(path: str, shape) -> np.ndarray:
    """The whole value of the leaf at `path` (keys joined by "/"), drawn
    from a seed of its path, so both packages make the same tree:
    matrices N(0, LEAF_STD^2), vectors 1 + N(0, LEAF_STD^2)."""
    rng = np.random.default_rng(zlib.crc32(path.encode()))
    x = LEAF_STD * rng.standard_normal(tuple(shape))
    return (x if len(shape) > 1 + path.startswith("blocks")
            else 1.0 + x).astype(np.float32)


def _tree_of(cfg):
    """`cfg`'s param tree (f32) of `leaf_values`."""
    return sharding._map_with_path(
        lambda p, x: torch.from_numpy(leaf_values("/".join(p), x.shape)),
        lm.abstract_params(cfg))


def _batch(cfg):
    return {k: torch.as_tensor(v) for k, v in
            synthetic.lm_batch(0, 0, 0, BATCH, SEQ, cfg.vocab).items()}


def _layer_input(cfg) -> np.ndarray:
    """The MoE layer's input (T, BATCH, SEQ, d): the residual stream."""
    rng = np.random.default_rng(7)
    return rng.standard_normal((cfg.spiking.t_steps, BATCH, SEQ,
                                cfg.d_model)).astype(np.float32)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().float().contiguous().numpy()
                          .tobytes()).hexdigest()


@contextlib.contextmanager
def one_thread():
    """The ranks' thread count (1) for a one-process run held to theirs bit
    for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@contextlib.contextmanager
def recorded_routes():
    """While active, every `moe.route` call's (ids, weights, sort order,
    keep), as numpy, in call order."""
    orig, got = tmoe.route, []

    def route(*args, **kwargs):
        r = orig(*args, **kwargs)
        got.append(tuple(t.detach().numpy().copy() for t in
                         (r.ids, r.weights, r.sort_idx, r.keep)))
        return r

    tmoe.route = route
    try:
        yield got
    finally:
        tmoe.route = orig


def _first_grads(step, params, opt, batch):
    """One step; its loss and the gradients AdamW received (f32 torch)."""
    got, orig = [], adamw.update

    def update(grads, *a, **k):
        got.extend(g.detach().float().clone() for g in adamw.leaves(grads))
        return orig(grads, *a, **k)

    adamw.update = update
    try:
        _, _, metrics = step(params, opt, batch)
    finally:
        adamw.update = orig
    return float(metrics["loss"]), got


def _served(cfg, params, tokens):
    """Spiking prefill logits and DECODE_STEPS greedy tokens of a pool of
    the rows of `tokens`, and every routing call on the way."""
    with torch.no_grad(), recorded_routes() as routes:
        logits = lm.prefill(cfg, params, tokens, True)
        state = lm.init_decode_state(cfg, tokens.shape[0], 8, True,
                                     device="cpu")
        tok, toks = logits.argmax(-1), []
        for i in range(DECODE_STEPS):
            lg, state = lm.decode_step(cfg, params, state, tok, SEQ + i,
                                       True)
            tok = lg.argmax(-1)
            toks.append(tok)
    return logits, torch.stack(toks), routes


def _moe_layer(cfg, params, x, dtype):
    """`lm._ffn` of the first MoE layer (group 0) on x, in `dtype`, under
    the ambient mesh: its own norm, fire, MoE and residual."""
    pattern, _ = lm.layer_pattern(cfg)
    i = next(k for k, spec in enumerate(pattern) if spec.ffn == "moe")
    pl = placement.of(cfg)
    p = pl.gathered(lm._group(params["blocks"][i], 0), ("blocks", str(i)),
                    layer=True)
    p = lm._tree_map(lambda t: t.to(dtype) if t.dtype == torch.bfloat16
                     else t, p)
    with torch.no_grad():
        return lm._ffn(cfg, pattern[i], p, x.to(dtype), True)


# ------------------------------------------------------------ rank bodies
def _case(name, mesh) -> dict:
    """One case on this rank of `mesh`: the served pool, the MoE layer,
    two bf16 training steps and the dense f32 step 0."""
    cfg = config(name)
    params = lm.init_params(cfg, 0, device="cpu")
    specs = sharding.param_specs(cfg, params, mesh)
    local = sharding.local_params(params, specs, mesh)
    drawn = sharding.local_init(cfg, 0, mesh, device="cpu")
    rows = ttrain.rank_rows(BATCH, mesh, cfg.pure_fsdp)
    batch = {k: v[rows] for k, v in _batch(cfg).items()}
    x = torch.from_numpy(_layer_input(cfg))[:, rows]
    out = {"rows": (rows.start, rows.stop), "coords": mesh.coords(),
           "local_init": all(torch.equal(a, b) for a, b in zip(
               adamw.leaves(drawn), adamw.leaves(local)))}
    with use_concrete_mesh(mesh):
        out["served"] = _served(cfg, local, batch["tokens"])
        out["layer"] = {str(dt): _moe_layer(cfg, local, x, dt)
                        for dt in (torch.float32, torch.bfloat16)}
    step = steps_mod.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3),
                                     mesh=mesh)
    opt = adamw.init(local)
    out["loss"], grads = _first_grads(step, local, opt, batch)
    local, opt, _ = step(local, opt, batch)
    out["after"] = [_digest(t) for t in adamw.leaves(local)]
    out["grads"] = [g.numpy() for g in sharding.full_leaves(
        adamw.unflatten(params, grads), specs, mesh)]
    whole = _tree_of(cfg)
    f32 = sharding.local_params(whole, sharding.param_specs(cfg, whole,
                                                            mesh), mesh)
    step = steps_mod.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3),
                                     spiking=False, mesh=mesh)
    out["f32_loss"], grads = _first_grads(step, f32, adamw.init(f32), batch)
    out["f32_grads"] = [g.numpy() for g in sharding.full_leaves(
        adamw.unflatten(whole, grads), specs, mesh)]
    if mesh.rank:                    # rank 0's whole gradients suffice
        out["grads"] = out["f32_grads"] = None
    return out


def world(world_size: int) -> dict:
    """Every case on every mesh of `world_size` ranks, on this rank."""
    torch.set_num_threads(1)
    out = {}
    for shape in (s for s in MESHES if s[0] * s[1] == world_size):
        mesh = make_rank_mesh(shape, AXES)
        for name, (_, _, shapes) in CASES.items():
            if shape in shapes:
                out[(name, shape)] = _case(name, mesh)
    return out


# ---------------------------------------------------------------- the JAX
JAX_REFERENCE = textwrap.dedent("""
    import dataclasses, os, sys, zlib
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0")
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs import registry
    from repro.data import synthetic
    from repro.launch.mesh import make_mesh, use_concrete_mesh
    from repro.models import lm
    from repro.runtime import sharding
    out = {}

    def tree_of(cfg):
        def leaf(kp, x):
            path = "/".join(sharding._path_str(kp))
            rng = np.random.default_rng(zlib.crc32(path.encode()))
            v = %(std)r * rng.standard_normal(x.shape)
            v = v if len(x.shape) > 1 + path.startswith("blocks") \\
                else 1.0 + v
            return jnp.asarray(v.astype(np.float32))
        return jax.tree_util.tree_map_with_path(leaf, lm.abstract_params(cfg))

    for name, arch, kw, shape in eval(sys.argv[2]):
        cfg = registry.get_reduced(arch)
        if "moe" in kw:
            kw["moe"] = dataclasses.replace(cfg.moe, **kw["moe"])
        cfg = cfg.replace(**kw)
        mesh = make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:shape[0] * shape[1]])
        params = tree_of(cfg)
        pshard = jax.tree.map(lambda s: NamedSharding(mesh, s),
                              sharding.param_specs(cfg, params, mesh))
        b = {k: jnp.asarray(v) for k, v in synthetic.lm_batch(
            0, 0, 0, %(batch)d, %(seq)d, cfg.vocab).items()}
        bshard = {k: NamedSharding(mesh, s) for k, s in
                  sharding.batch_specs(cfg, b, mesh).items()}
        with mesh, use_concrete_mesh(mesh):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, bb: lm.loss_fn(cfg, p, bb, False)),
                in_shardings=(pshard, bshard))(
                    jax.device_put(params, pshard), jax.device_put(b, bshard))
        key = f"{name}|{shape[0]}x{shape[1]}"
        out[f"{key}|loss"] = np.asarray(loss)
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[f"{key}|{i}"] = np.asarray(g, np.float32)
    np.savez(sys.argv[1], **out)
""" % dict(std=LEAF_STD, batch=BATCH, seq=SEQ))


def spawn_world(world_size: int, tmp) -> dict:
    """The ranks of `world` beside the reference's sharded steps on the
    same meshes, run in a subprocess on four host devices: (per rank,
    the JAX arrays)."""
    out = str(tmp / "jax.npz")
    cases = [(name, CASES[name][0], CASES[name][1], shape)
             for name, shape in combos(world_size)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_REFERENCE, out, repr(cases)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = distributed.spawn(world, world_size, backend="gloo",
                                  device="cpu", timeout_s=SPAWN_TIMEOUT,
                                  args=(world_size,))
        log, _ = jax_run.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, log[-3000:]
    return {"ranks": ranks, "jax": dict(np.load(out))}


# --------------------------------------------------- one-process references
def _logical_shape(name, shape) -> tuple:
    """The one-process mesh whose run is the yardstick of `name` on the
    rank mesh `shape`: its data shards matter to the expert-parallel form
    alone, its model positions where the products split over them."""
    cfg = config(name)
    if cfg.moe_shard_map:
        return shape
    return (1, 1 if cfg.pure_fsdp else shape[1])


@functools.lru_cache(maxsize=None)
def one_process(name, logical) -> dict:
    """The one-process run of `name` on a mesh of shape `logical` under
    `placement.witness`: the served pool, the MoE layer (and its plain
    form), step 0 in bf16 (spiking) and dense f32."""
    cfg = config(name)
    mesh = make_mesh(logical, AXES, devices="cpu")
    params = lm.init_params(cfg, 0, device="cpu")
    batch = _batch(cfg)
    x = torch.from_numpy(_layer_input(cfg))
    out = {}
    with one_thread():
        with placement.witness(), use_concrete_mesh(mesh):
            out["served"] = _served(cfg, params, batch["tokens"])
            out["layer"] = {str(dt): _moe_layer(cfg, params, x, dt)
                            for dt in (torch.float32, torch.bfloat16)}
        out["plain_layer"] = {str(dt): _moe_layer(cfg, params, x, dt)
                              for dt in (torch.float32, torch.bfloat16)}
        with placement.witness():
            step = steps_mod.make_train_step(
                cfg, adamw.AdamWConfig(lr=1e-3), mesh=mesh)
            out["loss"], grads = _first_grads(step, params,
                                              adamw.init(params), batch)
            out["grads"] = [g.numpy() for g in grads]
            whole = _tree_of(cfg)
            step = steps_mod.make_train_step(
                cfg, adamw.AdamWConfig(lr=1e-3), spiking=False, mesh=mesh)
            out["f32_loss"], grads = _first_grads(step, whole,
                                                  adamw.init(whole), batch)
            out["f32_grads"] = [g.numpy() for g in grads]
    return out


@functools.lru_cache(maxsize=None)
def parts_step(name, shape) -> dict:
    """Step 0 (bf16, spiking) as the batch ranks of `shape` compute it, on
    one process: each batch rank's loss terms on its rows in a thread of
    `placement.witness_parts` (under `placement.witness` on a (1, model)
    mesh), each with its own copy of every leaf (`placement.Split`: the
    copies' gradients summed in f32 in rank order, as the ranks' gradient
    all-reduce sums them), the counts summed over the threads, and one
    backward of every thread's loss."""
    cfg = config(name)
    n = shape[0] * (shape[1] if cfg.pure_fsdp else 1)
    params = lm.init_params(cfg, 0, device="cpu")
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    copies = [placement.Split.apply(p, n) for p in leaves]
    batch, per = _batch(cfg), BATCH // n

    def part(i):
        mine = adamw.unflatten(params, [c[i] for c in copies])
        return lm.loss_terms(cfg, mine, {k: v[i * per:(i + 1) * per]
                                         for k, v in batch.items()}, True)
    mesh = make_mesh((1, shape[1]), AXES, devices="cpu")
    with one_thread(), placement.witness(), use_concrete_mesh(mesh):
        terms = placement.witness_parts(part, n)
        cnt = torch.clamp(sum(c.detach() for _, c in terms), min=1.0)
        grads = torch.autograd.grad([t / cnt for t, _ in terms], leaves,
                                    allow_unused=True,
                                    materialize_grads=True)
    # the loss's sum over the batch ranks in f64, rounded once, as the
    # ranks' `group_sum` runs it
    loss = sum(t.detach().double() for t, _ in terms).float()
    return {"loss": float(loss / cnt),
            "grads": [g.float().numpy() for g in grads]}


def parted(shape, name) -> bool:
    """Whether batch ranks of `shape` hold other rows of `name`'s
    `moe_apply`: `parts_step` is then its yardstick bit for bit. Every
    sum over the ranks runs in the wider type (f32 for bf16 gradients,
    f64 for f32 ones and the loss) and is rounded once, so its bits do
    not depend on the order `gloo` picks: on two batch ranks and on pure
    FSDP's four on (2, 2) alike."""
    cfg = config(name)
    n = shape[0] * (shape[1] if cfg.pure_fsdp else 1)
    return not cfg.moe_shard_map and n > 1


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ checks
def check_routing(ranks, name, shape):
    """Every rank's routing calls equal the one-process run's: all of
    them for `moe_apply` (every rank routes the global tokens), and for
    the expert-parallel form the one-process call of the rank's data
    shard and model position (that form routes each data shard once a
    model position). Returns the dropped assignments per one-process
    call."""
    want = one_process(name, _logical_shape(name, shape))["served"][2]
    cfg = config(name)
    per = shape[0] * shape[1] if cfg.moe_shard_map else 1
    for r in ranks:
        got = r[(name, shape)]["served"][2]
        assert len(got) * per == len(want), (len(got), len(want))
        c = r[(name, shape)]["coords"]
        at = c["data"] * shape[1] + c["model"] if cfg.moe_shard_map else 0
        for k, call in enumerate(got):
            for a, b in zip(call, want[k * per + at]):
                assert np.array_equal(a, b), f"{name} {shape} call {k}"
    return [int((~keep).sum()) for *_, keep in want]


def check_served(ranks, name, shape):
    """Prefill logits and decoded tokens: each rank's pool rows equal the
    one-process pool's, bit for bit."""
    logits, toks, _ = one_process(name, _logical_shape(name, shape))[
        "served"]
    for r in ranks:
        case = r[(name, shape)]
        rows = slice(*case["rows"])
        got_logits, got_toks, _ = case["served"]
        assert torch.equal(got_logits, logits[rows]), f"{name} {shape}"
        assert torch.equal(got_toks, toks[:, rows]), f"{name} {shape}"


def exact(name, shape) -> bool:
    """Whether the ranks' sums over `model` must equal the witness's bit
    for bit. Every sum of partials is an f32 all-reduce rounded once
    (`placement.group_sum`); on two ranks it has one order, on more
    `gloo` picks it. Summing bf16 partials in f32 is nearly always exact,
    so no order shows; the expert-parallel form's router and its f32
    layer sum f32 partials, which on four ranks part from the witness's
    position order in the last bit (held within TOL instead). The other
    forms gather the expert outputs and sum nothing f32."""
    return not (config(name).moe_shard_map and shape[1] > 2)


def check_layer(ranks, name, shape):
    """The MoE layer alone, f32 and bf16, bit for bit with the witness;
    and with the plain one-process `moe_apply` layer where no shared
    experts run tensor-parallel (their row-split products round as the
    witness's per-position partials do), the bank is not cut inside its
    experts, and the form is `moe_apply` (the expert-parallel form sums
    partials, over data shards of their own capacity)."""
    cfg = config(name)
    ref = one_process(name, _logical_shape(name, shape))
    pl_tp = shape[1] > 1 and not cfg.pure_fsdp
    plain_too = not cfg.moe_shard_map and not (
        pl_tp and (cfg.moe.n_shared or cfg.moe.bank_size % shape[1]))
    for r in ranks:
        case = r[(name, shape)]
        rows = slice(*case["rows"])
        for dt, got in case["layer"].items():
            want = ref["layer"][dt][:, rows]
            if exact(name, shape) or dt == str(torch.bfloat16):
                assert torch.equal(got, want), f"{name} {shape} {dt}"
            else:
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=TOL * want.abs().max().item())
            if plain_too:
                assert torch.equal(got, ref["plain_layer"][dt][:, rows]), \
                    f"{name} {shape} {dt} against the plain layer"
    return plain_too


def step_gaps(ranks, name, shape) -> tuple:
    """(loss's relative gap, worst bf16 leaf's relative L2 gradient gap)
    of step 0 against the one-process step."""
    ref = one_process(name, _logical_shape(name, shape))
    r0 = ranks[0][(name, shape)]
    kinds = [t.dtype for t in adamw.leaves(lm.abstract_params(config(name)))]
    gaps = [_rel_l2(g, w) for g, w, k in zip(r0["grads"], ref["grads"], kinds)
            if k == torch.bfloat16 and np.abs(w).max() > 0]
    return abs(r0["loss"] - ref["loss"]) / abs(ref["loss"]), max(gaps)


def check_step(ranks, name, shape):
    """Step 0: on model ranks alone, bit for bit with the witness; where
    the ranks hold other rows, within LOSS_GAP and GRAD_GAP. The loss is
    one value on every rank."""
    cfg = config(name)
    ref = one_process(name, _logical_shape(name, shape))
    losses = {r[(name, shape)]["loss"] for r in ranks}
    assert len(losses) == 1, losses
    r0 = ranks[0][(name, shape)]
    if shape[0] == 1 and not cfg.pure_fsdp:
        assert r0["loss"] == ref["loss"], (r0["loss"], ref["loss"])
        for i, (g, w) in enumerate(zip(r0["grads"], ref["grads"])):
            if exact(name, shape):
                assert np.array_equal(g, w), f"{name} {shape} leaf {i}"
            else:
                assert _rel_l2(g, w) <= TOL, f"{name} {shape} leaf {i}"
        return
    loss_gap, grad_gap = step_gaps(ranks, name, shape)
    assert loss_gap <= LOSS_GAP, loss_gap
    assert grad_gap <= GRAD_GAP, grad_gap
    kinds = [t.dtype for t in adamw.leaves(lm.abstract_params(cfg))]
    for i, (g, w, k) in enumerate(zip(r0["grads"], ref["grads"], kinds)):
        if k == torch.float32 and np.abs(w).max() > 0:
            # an f32 leaf's gradient sums the ranks' bf16-rounded parts
            # of the leaves below it
            assert _rel_l2(g, w) <= GRAD_GAP, f"{name} {shape} leaf {i}"


def check_parts(ranks, name, shape):
    """Where the ranks hold other rows of `moe_apply`'s batch: step 0's
    loss and every gradient bit for bit with `parts_step`, the one-process
    run of the ranks' arithmetic (the witness of the gaps to the
    one-process step that `check_step` bounds)."""
    want = parts_step(name, shape)
    r0 = ranks[0][(name, shape)]
    assert r0["loss"] == want["loss"], (r0["loss"], want["loss"])
    for i, (g, w) in enumerate(zip(r0["grads"], want["grads"])):
        assert np.array_equal(g, w), \
            f"{name} {shape} leaf {i}: {np.abs(g - w).max()}"


def check_blocks(ranks, name, shape):
    """After two steps the ranks that hold the same block of a leaf (the
    same coordinates on the axes its spec splits it over) hold it bit for
    bit."""
    cfg = config(name)
    whole = lm.abstract_params(cfg)
    mesh = abstract_mesh(shape, AXES)
    axes = sharding.leaf_split_axes(
        whole, sharding.param_specs(cfg, whole, mesh), mesh)
    for i, split in enumerate(axes):
        held: dict = {}
        for r in ranks:
            case = r[(name, shape)]
            key = tuple(case["coords"][a] for a in sorted(split))
            held.setdefault(key, set()).add(case["after"][i])
        assert all(len(d) == 1 for d in held.values()), \
            f"{name} {shape} leaf {i}: {held}"


def check_jax(jax_ref, ranks, name, shape):
    """The dense f32 step 0 against the reference's sharded step, and
    against the port's one-process step (the witness of the bf16 gaps:
    in f32 the ranks' sums round 2^16 times finer)."""
    cfg = config(name)
    tol = SSM_TOL if cfg.hybrid is not None else TOL
    key = f"{name}|{shape[0]}x{shape[1]}"
    r0 = ranks[0][(name, shape)]
    want = float(jax_ref[f"{key}|loss"])
    assert abs(r0["f32_loss"] - want) <= tol * abs(want), \
        (r0["f32_loss"], want)
    ref = one_process(name, _logical_shape(name, shape))
    for i, (g, own) in enumerate(zip(r0["f32_grads"], ref["f32_grads"])):
        w = jax_ref[f"{key}|{i}"]
        assert g.shape == w.shape, f"leaf {i}: {g.shape} vs {w.shape}"
        bound = tol * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= bound, f"{key} leaf {i}"
        assert float(np.abs(g - own).max()) <= bound, f"{key} leaf {i}"


# -------------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return spawn_world(2, tmp_path_factory.mktemp("moe2"))


@pytest.mark.parametrize("combo", combos(2), ids=combo_id)
def test_routing_equals_the_one_process_runs(two_ranks, combo):
    drops = check_routing(two_ranks["ranks"], *combo)
    # the reduced qwen2-moe as configured drops assignments for capacity,
    # so the drops are compared too
    assert combo[0] != "qwen" or any(drops), "the capacity binds nowhere"


@pytest.mark.parametrize("combo", combos(2), ids=combo_id)
def test_served_pool_equals_the_one_process_pool(two_ranks, combo):
    check_served(two_ranks["ranks"], *combo)


@pytest.mark.parametrize("combo", combos(2), ids=combo_id)
def test_moe_layer_is_bit_for_bit_the_one_process_layer(two_ranks, combo):
    check_layer(two_ranks["ranks"], *combo)


@pytest.mark.parametrize("combo", combos(2), ids=combo_id)
def test_step_zero_meets_the_one_process_step(two_ranks, combo):
    check_step(two_ranks["ranks"], *combo)


@pytest.mark.parametrize("combo", [c for c in combos(2) if parted(*c[::-1])],
                         ids=combo_id)
def test_step_zero_is_the_batch_ranks_witness(two_ranks, combo):
    check_parts(two_ranks["ranks"], *combo)


@pytest.mark.parametrize("combo", combos(2), ids=combo_id)
def test_every_block_is_the_same_bits_on_every_rank_that_holds_it(
        two_ranks, combo):
    check_blocks(two_ranks["ranks"], *combo)


@pytest.mark.parametrize("combo", combos(2), ids=combo_id)
def test_f32_step_zero_matches_the_reference_sharded_step(two_ranks, combo):
    check_jax(two_ranks["jax"], two_ranks["ranks"], *combo)


@pytest.mark.parametrize("combo", combos(2), ids=combo_id)
def test_local_init_draws_the_seeds_local_params(two_ranks, combo):
    """`sharding.local_init`, each leaf cut as it is drawn, gives every
    rank its `local_params` of the seed's whole tree bit for bit."""
    assert all(r[combo]["local_init"] for r in two_ranks["ranks"])


@pytest.mark.parametrize("shape, pure_fsdp", [((2, 1), False),
                                              ((2, 2), False),
                                              ((2, 2), True)])
def test_rank_rows_follow_the_reference_microbatches(shape, pure_fsdp):
    """With m microbatches each batch rank takes its block of each, so the
    ranks' i-th microbatches joined in rank order are the global rows of
    the reference's i-th, which an MoE routes together."""
    m, rows = 2, 16
    n = shape[0] * (shape[1] if pure_fsdp else 1)
    got = {}
    for rank in range(shape[0] * shape[1]):
        mesh = RankMesh(shape, AXES, rank, torch.device("cpu"), {})
        idx = np.asarray(ttrain.rank_rows(rows, mesh, pure_fsdp, m))
        got[rank // (1 if pure_fsdp else shape[1])] = idx.reshape(m, -1)
    for i in range(m):
        joined = np.concatenate([got[c][i] for c in range(n)])
        assert np.array_equal(joined, np.arange(i * rows // m,
                                                (i + 1) * rows // m))
