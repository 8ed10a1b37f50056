"""Every leaf placed on ranks by `param_specs`: tensor-parallel, FSDP and
pure-FSDP placement across `gloo` processes on the CPU, against the JAX
package's own placement and its sharded training step on a host mesh of
the same shape.

Every spawn (`launch.distributed.spawn`) joins its ranks with a deadline
of SPAWN_TIMEOUT seconds. Two worlds carry the checks, each spawned once
by a module fixture: two ranks ((1, 2) and (2, 1) rank meshes) and four
ranks ((2, 2) and (1, 4), and a (4, 1) save). JAX runs in a subprocess
on four host devices and writes an .npz; the ranks import this module
and never JAX.

Yardsticks:
  * placement: on each mesh, each rank's `local_params` shard of every
    leaf of the reduced TinyLlama (plain, fsdp, pure_fsdp), qwen2-moe
    (fsdp) and the two SSM configs (jamba, xLSTM) is bit for bit the
    shard JAX's `NamedSharding` places on the same position (read
    through `addressable_shards`), and every leaf a spec splits is cut;
  * training: step 0's loss within 1e-5 relative, and each rank's
    gradient shards within 1e-5 of max|ref| per leaf, of the reference's
    `jax.value_and_grad(loss_fn)` jitted with the params and gradients
    placed by `param_specs` and the batch by `batch_specs`, in f32 (the
    ranks' row-split products sum their partials in another order than
    GSPMD's, and the column splits compute whole outputs);
  * the witness: the rank run of the bf16 reduced TinyLlama (spiking and
    dense), qwen3-4b (dense, qk-norm) and qwen2-moe (spiking) on (1, 2),
    prefill logits, four served tokens, the loss and every gradient,
    equals the one-process run of the same arithmetic
    (`placement.witness`) bit for bit;
  * after three steps, every rank that holds a block of a leaf holds the
    same bits as the others that hold it;
  * a rank mesh of one process gives today's one-process results bit
    for bit; the reshard round trip ((2, 2) -> (1, 4), (4, 1) -> (2, 2))
    restores each rank's shards exactly; pure FSDP holds one group's
    gathered weights at a time.
"""
import contextlib
import dataclasses
import hashlib
import os
import subprocess
import sys
import textwrap
import weakref
import zlib

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
from repro_torch.launch.mesh import abstract_mesh, make_mesh, \
    make_rank_mesh, use_concrete_mesh
from repro_torch.models import lm, placement
from repro_torch.optim import adamw
from repro_torch.runtime import elastic, sharding

torch.set_num_threads(1)
SPAWN_TIMEOUT = 240
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")
SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
TOL = 1e-5


def _reduced(arch, **kw):
    return treg.get_reduced(arch).replace(**kw)


# Placement: the reduced configs of the three families, by name.
PLACE_CONFIGS = {
    "dense": ("tinyllama-1.1b", {}),
    "dense_fsdp": ("tinyllama-1.1b", {"fsdp": True}),
    "dense_pure_fsdp": ("tinyllama-1.1b", {"pure_fsdp": True}),
    "moe_fsdp": ("qwen2-moe-a2.7b", {"fsdp": True, "moe_shard_map": True}),
    "ssm_jamba": ("jamba-1.5-large-398b", {"fsdp": True}),
    "ssm_xlstm": ("xlstm-350m", {}),
}
# Training against the reference: a small dense config (2 query heads a
# KV head, so (1, 4) cuts a KV head and runs attention whole), with and
# without qk-norm (its scales are whole on every model rank but read by
# each rank's own heads), and the reduced MoE through the
# expert-parallel MoE; dense mode, f32.
TRAIN = LMConfig(name="place", family="dense", n_layers=2, d_model=32,
                 n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                 spiking=SpikingConfig(t_steps=1), remat="none",
                 loss_chunk=16)
TRAIN_CASES = {
    "tp_1x2": (TRAIN, (1, 2)),
    "tp_qk_norm_1x2": (TRAIN.replace(qk_norm=True), (1, 2)),
    "tp_fsdp_qk_norm_2x2": (TRAIN.replace(qk_norm=True, fsdp=True), (2, 2)),
    "dp_2x1": (TRAIN, (2, 1)),
    "tp_fsdp_2x2": (TRAIN.replace(fsdp=True), (2, 2)),
    "tp_whole_heads_1x4": (TRAIN, (1, 4)),
    "pure_fsdp_2x2": (TRAIN.replace(pure_fsdp=True), (2, 2)),
    "pure_fsdp_2x1": (TRAIN.replace(pure_fsdp=True, fsdp=True), (2, 1)),
    "moe_tp_1x2": (_reduced("qwen2-moe-a2.7b", moe_shard_map=True), (1, 2)),
}
BATCH, SEQ = 8, 16
LEAF_STD = 0.1


def _place_cfg(name):
    arch, kw = PLACE_CONFIGS[name]
    return _reduced(arch, **kw)


def leaf_values(path: str, shape) -> np.ndarray:
    """The whole value of the leaf at `path` (keys joined by "/"), drawn
    from a seed of its path: both packages make the same tree. Matrices
    N(0, LEAF_STD^2), vectors (norm scales) 1 + N(0, LEAF_STD^2)."""
    rng = np.random.default_rng(zlib.crc32(path.encode()))
    x = LEAF_STD * rng.standard_normal(tuple(shape))
    return (x if len(shape) > 1 + path.startswith("blocks")
            else 1.0 + x).astype(np.float32)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.float32)
                          .tobytes()).hexdigest()


def _paths(tree) -> list:
    out = []
    sharding._map_with_path(lambda p, x: out.append(("/".join(p), x)), tree)
    return out


def _tree_of(cfg):
    """`cfg`'s param tree (f32) of `leaf_values`."""
    return sharding._map_with_path(
        lambda p, x: torch.from_numpy(leaf_values("/".join(p), x.shape)),
        lm.abstract_params(cfg))


def _f32(tree):
    return lm._tree_map(lambda t: t.float(), tree)


@contextlib.contextmanager
def one_thread():
    """The ranks' thread count (1) for a one-process run held to theirs bit
    for bit: a CPU GEMM may split its sums by thread, and other test
    modules set other counts when they are imported."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _batch(cfg, rows=BATCH, seq=SEQ):
    return {k: torch.as_tensor(v) for k, v in
            synthetic.lm_batch(0, 0, 0, rows, seq, cfg.vocab).items()}


# ------------------------------------------------------------ rank bodies
def _placements(shape) -> dict:
    """name -> path -> (shard digest, shard shape, whether cut) of this
    rank's `local_params` shards."""
    mesh = make_rank_mesh(shape, AXES)
    out = {}
    for name in PLACE_CONFIGS:
        cfg = _place_cfg(name)
        whole = _tree_of(cfg)
        specs = sharding.param_specs(cfg, whole, mesh)
        local = sharding.local_params(whole, specs, mesh)
        out[name] = {p: (_digest(t.numpy()), tuple(t.shape),
                         t.shape != w.shape)
                     for (p, t), (_, w) in zip(_paths(local),
                                               _paths(whole))}
    return out


def _first_grads(step, params, opt, batch):
    """One step; its loss and the gradients AdamW received (numpy)."""
    got, orig = [], adamw.update

    def update(grads, *a, **k):
        got.extend(g.detach().float().numpy().copy()
                   for g in adamw.leaves(grads))
        return orig(grads, *a, **k)

    adamw.update = update
    try:
        _, _, metrics = step(params, opt, batch)
    finally:
        adamw.update = orig
    return float(metrics["loss"]), got


def _train_case(name) -> dict:
    """Step 0 of `TRAIN_CASES[name]` on its rank mesh: the global loss and
    this rank's gradient shards, from `leaf_values` params; then two more
    steps, and the digests of this rank's leaves after them."""
    cfg, shape = TRAIN_CASES[name]
    mesh = make_rank_mesh(shape, AXES)
    whole = _tree_of(cfg)
    local = sharding.local_params(
        whole, sharding.param_specs(cfg, whole, mesh), mesh)
    rows = ttrain.rank_rows(BATCH, mesh, cfg.pure_fsdp)
    batch = {k: v[rows] for k, v in _batch(cfg).items()}
    step = steps_mod.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3),
                                     spiking=False, mesh=mesh)
    opt = adamw.init(local)
    loss, grads = _first_grads(step, local, opt, batch)
    for _ in range(2):
        local, opt, _ = step(local, opt, batch)
    return {"loss": loss, "grads": grads, "rank": mesh.rank,
            "coords": mesh.coords(),
            "after": [_digest(t.detach().float().numpy())
                      for t in adamw.leaves(local)]}


def _served(cfg, params, tokens, spiking):
    """Prefill logits, four greedy decode tokens and the decode state,
    no autograd."""
    with torch.no_grad():
        logits = lm.prefill(cfg, params, tokens, spiking)
        state = lm.init_decode_state(cfg, tokens.shape[0], 8, spiking,
                                     device="cpu")
        tok, toks = tokens[:, -1], []
        for i in range(4):
            lg, state = lm.decode_step(cfg, params, state, tok, i, spiking)
            tok = lg.argmax(-1)
            toks.append(tok)
    return logits, torch.stack(toks), state


def _witness_run(cfg, mesh, params, spiking):
    """(prefill logits, tokens, decode state leaves' shapes, loss, whole
    gradients) of the bf16 `cfg` on `mesh` (ambient)."""
    b = _batch(cfg, rows=4)
    with use_concrete_mesh(mesh):
        logits, toks, state = _served(cfg, params, b["tokens"], spiking)
    step = steps_mod.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3),
                                     spiking=spiking, mesh=mesh)
    loss, grads = _first_grads(step, params, adamw.init(params), b)
    shapes = [tuple(t.shape) for t in adamw.leaves(state) if t is not None]
    return logits, toks, shapes, loss, grads


def _witness_cfgs():
    """name -> (config, spiking): SDSA statuses or a dense KV cache."""
    return {"dense": (treg.get_reduced("tinyllama-1.1b"), True),
            "dense_kv_cache": (treg.get_reduced("tinyllama-1.1b"), False),
            "qk_norm_kv_cache": (treg.get_reduced("qwen3-4b"), False),
            "moe": (_reduced("qwen2-moe-a2.7b", moe_shard_map=True), True)}


def _witness_ranks() -> dict:
    """The rank side of the witness on (1, 2): gradients gathered whole,
    and the shapes `decode_state_specs` cuts the whole decode state to
    on this rank."""
    mesh = make_rank_mesh((1, 2), AXES)
    out = {}
    for name, (cfg, spiking) in _witness_cfgs().items():
        params = lm.init_params(cfg, 0, device="cpu")
        specs = sharding.param_specs(cfg, params, mesh)
        local = sharding.local_params(params, specs, mesh)
        gathers, orig = [], placement._GatherLeaf.apply
        placement._GatherLeaf.apply = lambda *a: gathers.append(a) or \
            orig(*a)
        try:
            logits, toks, shapes, loss, grads = _witness_run(
                cfg, mesh, local, spiking)
        finally:
            placement._GatherLeaf.apply = orig
        grads = [torch.from_numpy(g) for g in grads]
        whole = [g.numpy() for g in sharding.full_leaves(
            adamw.unflatten(params, grads), specs, mesh)]
        state = lm.init_decode_state(cfg, 4, 8, spiking, device="cpu")
        placed = sharding.local_params(state, sharding.decode_state_specs(
            cfg, state, mesh), mesh)
        out[name] = (logits, toks, shapes, loss, whole,
                     [tuple(t.shape) for t in adamw.leaves(placed)
                      if t is not None], len(gathers))
    return out


def _gathers_alive(cfg, mesh) -> dict:
    """Most gathered block weights alive at once (at each gather, in the
    forward and in the backward's recompute) of a pure-FSDP step, and
    how many are alive when the forward has returned."""
    alive, peak, orig = [], [0], placement._GatherLeaf.apply

    def tracked(*args):
        out = orig(*args)
        alive[:] = [r for r in alive if r() is not None]
        alive.append(weakref.ref(out))
        peak[0] = max(peak[0], len(alive))
        return out

    params = lm.init_params(cfg, 0, device="cpu")
    local = sharding.local_params(
        params, sharding.param_specs(cfg, params, mesh), mesh)
    leaves = adamw.leaves(local)
    for p in leaves:
        p.requires_grad_(True)
    rows = ttrain.rank_rows(BATCH, mesh, True)
    batch = {k: v[rows] for k, v in _batch(cfg).items()}
    placement._GatherLeaf.apply = tracked
    try:
        with use_concrete_mesh(mesh):
            tot, _ = lm.loss_terms(cfg, local, batch, True)
        after_forward = sum(r() is not None for r in alive)
        peak_forward = peak[0]
        peak[0] = 0
        # outside the mesh: the recompute installs the forward's
        torch.autograd.grad(tot, leaves, allow_unused=True)
    finally:
        placement._GatherLeaf.apply = orig
    per_block = len(adamw.leaves(params["blocks"]))
    return {"peak_forward": peak_forward, "peak_backward": peak[0],
            "after_forward": after_forward, "per_group": per_block}


def _two_ranks() -> dict:
    torch.set_num_threads(1)
    out = {"place": {s: _placements(s) for s in SHAPES[2]},
           "train": {n: _train_case(n) for n, (_, s) in TRAIN_CASES.items()
                     if s[0] * s[1] == 2},
           "witness": _witness_ranks()}
    cfg = TRAIN.replace(pure_fsdp=True, remat="full")
    out["alive"] = _gathers_alive(cfg, make_rank_mesh((2, 1), AXES))
    return out


def _state_shards(cfg, mesh, mgr):
    """Each leaf of the newest snapshot restored onto `mesh` (cut as it is
    read), beside the same snapshot restored whole and cut by
    `local_params`: digests of both."""
    whole = lm.abstract_params(cfg)
    target = (whole, adamw.init(whole))
    step, restored = elastic.reshard_restore(cfg, mgr, target, mesh)
    _, full = mgr.restore_latest(target, "cpu")
    specs = sharding.state_specs(sharding.param_specs(cfg, whole, mesh))
    want = sharding.local_params(full, specs, mesh)
    gathered = list(sharding.full_leaves(restored, specs, mesh))
    return {"step": step,
            "got": [_digest(t.float().numpy()) for t in
                    adamw.leaves(restored)],
            "want": [_digest(t.float().numpy()) for t in adamw.leaves(want)],
            "whole": all(torch.equal(a, b) for a, b in
                         zip(gathered, adamw.leaves(full)))}


def _save_on(cfg, shape, ck_dir) -> None:
    """One training step on a `shape` rank mesh, then rank 0 writes the
    state gathered whole from every rank's shards."""
    mesh = make_rank_mesh(shape, AXES)
    params = lm.init_params(cfg, 0, device="cpu")
    specs = sharding.param_specs(cfg, params, mesh)
    local = sharding.local_params(params, specs, mesh)
    opt = adamw.init(local)
    step = steps_mod.make_train_step(cfg, adamw.AdamWConfig(lr=1e-2),
                                     spiking=False, mesh=mesh)
    rows = ttrain.rank_rows(BATCH, mesh, cfg.pure_fsdp)
    local, opt, _ = step(local, opt,
                         {k: v[rows] for k, v in _batch(cfg).items()})
    mgr = CheckpointManager(ck_dir, save_every=1, writer=mesh.rank == 0)
    mgr.save(1, leaves=sharding.full_leaves(
        (local, opt), sharding.state_specs(specs), mesh))
    mgr.wait()
    distributed.barrier()


def _four_ranks(ck_dir) -> dict:
    torch.set_num_threads(1)
    out = {"place": {s: _placements(s) for s in SHAPES[4]},
           "train": {n: _train_case(n) for n, (_, s) in TRAIN_CASES.items()
                     if s[0] * s[1] == 4}}
    cfg = TRAIN.replace(fsdp=True)
    for src, dst in (((2, 2), (1, 4)), ((4, 1), (2, 2))):
        d = os.path.join(ck_dir, f"{src[0]}x{src[1]}")
        _save_on(cfg, src, d)
        mgr = CheckpointManager(d, save_every=1,
                                writer=distributed.rank() == 0)
        out[f"{src}->{dst}"] = _state_shards(cfg, make_rank_mesh(dst, AXES),
                                             mgr)
    return out


def _mesh_of_one() -> dict:
    """`train_loop` on a (1, 1) rank mesh: losses and final params."""
    torch.set_num_threads(1)
    cfg = TRAIN.replace(fsdp=True)
    out = ttrain.train_loop(cfg, mesh=make_rank_mesh((1, 1), AXES),
                            device="cpu", steps=3, batch=4, seq=16,
                            log_every=100)
    return {"losses": out["losses"],
            "params": [t.detach().clone() for t in
                       adamw.leaves(out["params"])]}


# ---------------------------------------------------------------- the JAX
JAX_REFERENCE = textwrap.dedent("""
    import hashlib, os, sys, zlib
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0")
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs import registry
    from repro.configs.base import LMConfig, SpikingConfig
    from repro.data import synthetic
    from repro.launch.mesh import make_mesh, use_concrete_mesh
    from repro.models import lm
    from repro.runtime import sharding
    place, train = eval(sys.argv[2]), eval(sys.argv[3])
    out = {}

    def path_of(kp):
        return "/".join(sharding._path_str(kp))

    def tree_of(cfg):
        def leaf(kp, x):
            path = path_of(kp)
            rng = np.random.default_rng(zlib.crc32(path.encode()))
            v = %(std)r * rng.standard_normal(x.shape)
            v = v if len(x.shape) > 1 + path.startswith("blocks") \
                else 1.0 + v
            return jnp.asarray(v.astype(np.float32))
        return jax.tree_util.tree_map_with_path(leaf, lm.abstract_params(cfg))

    def mesh_of(shape):
        return make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:shape[0] * shape[1]])

    def position(mesh, device):
        return list(mesh.devices.flat).index(device)

    for name, arch, kw, shape in place:
        cfg = registry.get_reduced(arch).replace(**kw)
        mesh = mesh_of(shape)
        params = tree_of(cfg)
        specs = sharding.param_specs(cfg, params, mesh)
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        for (kp, x), spec in zip(flat, jax.tree.leaves(
                specs, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))):
            y = jax.device_put(x, NamedSharding(mesh, spec))
            for s in y.addressable_shards:
                d = np.ascontiguousarray(np.asarray(s.data), np.float32)
                out[f"place|{name}|{shape}|{path_of(kp)}|"
                    f"{position(mesh, s.device)}"] = np.frombuffer(
                    hashlib.sha256(d.tobytes()).hexdigest().encode(),
                    np.uint8)

    for name, cfg_kw, shape, batch, seq in train:
        if "arch" in cfg_kw:
            cfg = registry.get_reduced(cfg_kw.pop("arch")).replace(**cfg_kw)
        else:
            cfg = LMConfig(spiking=SpikingConfig(t_steps=1), **cfg_kw)
        mesh = mesh_of(shape)
        params = tree_of(cfg)
        pshard = jax.tree.map(lambda s: NamedSharding(mesh, s),
                              sharding.param_specs(cfg, params, mesh))
        b = {k: jnp.asarray(v) for k, v in
             synthetic.lm_batch(0, 0, 0, batch, seq, cfg.vocab).items()}
        bshard = {k: NamedSharding(mesh, s) for k, s in
                  sharding.batch_specs(cfg, b, mesh).items()}
        with mesh, use_concrete_mesh(mesh):
            fn = jax.jit(jax.value_and_grad(
                lambda p, bb: lm.loss_fn(cfg, p, bb, False)),
                in_shardings=(pshard, bshard),
                out_shardings=(NamedSharding(mesh, jax.sharding
                                             .PartitionSpec()), pshard))
            loss, grads = fn(jax.device_put(params, pshard),
                             jax.device_put(b, bshard))
        out[f"train|{name}|loss"] = np.asarray(loss)
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[f"train|{name}|{i}|max"] = np.abs(np.asarray(g)).max()
            for s in g.addressable_shards:
                out[f"train|{name}|{i}|{position(mesh, s.device)}"] = \\
                    np.asarray(s.data, np.float32)
    np.savez(sys.argv[1], **out)
""" % dict(std=LEAF_STD))


def _train_kw(cfg) -> dict:
    """The config for the JAX side: the reduced MoE's overrides with its
    arch's name, or the fields of the hand-made config (its spiking
    config left to the reference's T = 1 default)."""
    if cfg.moe is not None:
        return {"arch": "qwen2-moe-a2.7b", "moe_shard_map": True}
    kw = dataclasses.asdict(cfg)
    kw.pop("spiking")
    return {k: v for k, v in kw.items() if v is not None}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("place") / "jax.npz")
    place = [(name, *PLACE_CONFIGS[name], shape) for name in PLACE_CONFIGS
             for n in SHAPES for shape in SHAPES[n]]
    train = [(name, _train_kw(cfg), shape, BATCH, SEQ)
             for name, (cfg, shape) in TRAIN_CASES.items()]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", JAX_REFERENCE, out,
                          repr(place), repr(train)], env=env,
                         capture_output=True, text=True,
                         timeout=SPAWN_TIMEOUT)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def two_ranks():
    return distributed.spawn(_two_ranks, 2, backend="gloo", device="cpu",
                             timeout_s=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("place4"))
    return distributed.spawn(_four_ranks, 4, backend="gloo", device="cpu",
                             timeout_s=SPAWN_TIMEOUT, args=(ck,))


def _world(shape, two_ranks, four_ranks):
    return two_ranks if shape[0] * shape[1] == 2 else four_ranks


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("shape", [s for n in SHAPES for s in SHAPES[n]],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(PLACE_CONFIGS))
def test_every_leaf_shard_is_the_jax_addressable_shard(
        jax_ref, two_ranks, four_ranks, name, shape):
    """Each rank's shard of every leaf is, bit for bit, the one JAX's
    `NamedSharding(mesh, param_specs(...))` puts on the same position;
    where the reference's spec splits a leaf on the mesh, the rank holds
    a cut, not the whole leaf."""
    ranks = _world(shape, two_ranks, four_ranks)
    cfg = _place_cfg(name)
    mesh = abstract_mesh(shape, AXES)
    specs = sharding.param_specs(cfg, lm.abstract_params(cfg), mesh)
    spec_of = dict(("/".join(p), s) for p, s in sharding._spec_leaves(specs))
    cut_somewhere = False
    for r, rank in enumerate(ranks):
        got = rank["place"][shape][name]
        assert set(got) == set(spec_of)
        for path, (digest, shard_shape, cut) in got.items():
            want = bytes(jax_ref[f"place|{name}|{shape}|{path}|{r}"]).decode()
            assert digest == want, f"{name} {shape} rank {r}: {path}"
            split = bool(sharding.splits(spec_of[path], mesh))
            assert cut == split, f"{path}: spec {spec_of[path]}, cut {cut}"
            cut_somewhere |= cut
    # (the plain config on (2, 1) splits nothing: no model axis, no fsdp)
    assert cut_somewhere == any(sharding.splits(s, mesh)
                                for s in spec_of.values())


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_step_zero_matches_the_reference_sharded_step(jax_ref, two_ranks,
                                                      four_ranks, case):
    """Step 0's global loss within TOL relative and each rank's gradient
    shards within TOL of max|ref| per leaf, against the reference's
    jitted `value_and_grad` on the same host mesh (f32, dense)."""
    _, shape = TRAIN_CASES[case]
    ranks = _world(shape, two_ranks, four_ranks)
    want = float(jax_ref[f"train|{case}|loss"])
    for r, rank in enumerate(ranks):
        got = rank["train"][case]
        assert got["rank"] == r
        assert abs(got["loss"] - want) <= TOL * abs(want), (got["loss"],
                                                            want)
        for i, g in enumerate(got["grads"]):
            w = jax_ref[f"train|{case}|{i}|{r}"]
            assert g.shape == w.shape, f"leaf {i}: {g.shape} vs {w.shape}"
            bound = TOL * float(jax_ref[f"train|{case}|{i}|max"])
            err = float(np.abs(g - w).max())
            assert err <= bound, f"{case} rank {r} leaf {i}: {err} > {bound}"


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_every_block_is_the_same_bits_on_every_rank_that_holds_it(
        two_ranks, four_ranks, case):
    """After three steps, the ranks that hold the same block of a leaf
    (the same coordinates on the axes its spec splits it over; every rank
    for a replicated leaf) hold it bit for bit: each gradient is summed
    over every rank that computed a part of it, so no copy drifts."""
    cfg, shape = TRAIN_CASES[case]
    ranks = [r["train"][case] for r in _world(shape, two_ranks, four_ranks)]
    whole = lm.abstract_params(cfg)
    mesh = abstract_mesh(shape, AXES)
    axes = sharding.leaf_split_axes(
        whole, sharding.param_specs(cfg, whole, mesh), mesh)
    for i, split in enumerate(axes):
        held: dict = {}
        for r in ranks:
            key = tuple(r["coords"][a] for a in sorted(split))
            held.setdefault(key, set()).add(r["after"][i])
        assert all(len(d) == 1 for d in held.values()), \
            f"{case} leaf {i} (split over {sorted(split)}): {held}"


@pytest.mark.parametrize("name", ["dense", "dense_kv_cache",
                                  "qk_norm_kv_cache", "moe"])
def test_rank_run_equals_the_one_process_witness_bit_for_bit(two_ranks,
                                                             name):
    """bf16, (1, 2), spiking (SDSA statuses) or dense (a KV cache): the
    ranks' prefill logits, served tokens, loss and every gradient equal
    `placement.witness`'s one-process run of the same arithmetic bit for
    bit (its row-split partials summed in position order; the ranks'
    all-reduce sums the same two), and each rank's decode state holds
    its own heads, the shapes `decode_state_specs` cuts the whole state
    to. Nothing is
    gathered: every split leaf (attention, MLP, shared experts, expert
    banks, embedding, head) is used as its shard."""
    cfg, spiking = _witness_cfgs()[name]
    params = lm.init_params(cfg, 0, device="cpu")
    with placement.witness(), one_thread():
        want = _witness_run(cfg, make_mesh((1, 2), AXES, devices="cpu"),
                            params, spiking)
    heads = (cfg.n_heads if spiking else cfg.n_kv_heads) // 2
    for rank in two_ranks:
        logits, toks, shapes, loss, grads, placed, gathers = \
            rank["witness"][name]
        assert gathers == 0
        assert torch.equal(logits, want[0])
        assert torch.equal(toks, want[1])
        assert loss == want[3]
        assert shapes == placed
        assert all(s[-2] == heads for s in shapes), shapes
        for i, (g, w) in enumerate(zip(grads, want[4])):
            assert np.array_equal(g, w), f"{name} leaf {i}"


def test_a_rank_mesh_of_one_is_the_one_process_run_bit_for_bit():
    """`train_loop` on a (1, 1) rank mesh, fsdp on: every placement
    helper is the identity, so losses and params equal the plain loop's
    bit for bit."""
    got = distributed.spawn(_mesh_of_one, 1, backend="gloo", device="cpu",
                            timeout_s=SPAWN_TIMEOUT)[0]
    with one_thread():
        want = ttrain.train_loop(TRAIN.replace(fsdp=True), device="cpu",
                                 steps=3, batch=4, seq=16, log_every=100)
    assert got["losses"] == want["losses"]
    for a, b in zip(got["params"], adamw.leaves(want["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("move", ["(2, 2)->(1, 4)", "(4, 1)->(2, 2)"])
def test_reshard_round_trip_restores_every_shard_exactly(four_ranks, move):
    """A TP + FSDP training state saved from one rank mesh restores onto
    another with each leaf cut to the new rank's shard as it is read:
    exactly `local_params` of the saved whole state, and gathered back
    whole it is the saved state bit for bit."""
    for rank in four_ranks:
        got = rank[move]
        assert got["step"] == 1
        assert got["got"] == got["want"]
        assert got["whole"]


def test_pure_fsdp_holds_one_groups_gathered_weights_at_a_time(two_ranks):
    """pure FSDP on (2, 1), two groups: no more gathered weights alive at
    once than one group's leaves and the two top-level matrices (the
    embedding, the LM head gathered once for the loss), in the forward
    and in the backward's recompute (run outside the mesh, which the
    recompute installs again); once the forward has returned only the
    head is kept."""
    for rank in two_ranks:
        a = rank["alive"]
        assert 0 < a["peak_forward"] <= a["per_group"] + 2, a
        assert 0 < a["peak_backward"] <= a["per_group"] + 2, a
        assert a["after_forward"] <= 1, a
