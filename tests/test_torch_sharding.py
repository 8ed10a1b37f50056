"""The port's sharding rules and sharded event execution against `repro`'s,
on the CPU.

Spec trees: for every config of the registry, at the production meshes
(16, 16) and (2, 16, 16) (abstract: no devices), the port's specs on its
`meta` param tree equal `repro`'s `PartitionSpec`s on its abstract tree
(compared as tuples, leaf by leaf along the same paths), and neither has
a `validate_specs` problem. The same for batch and decode-state specs.

`event_op_sharded`: 8 logical shards on the CPU, where each shard's kernel
wrapper runs its plain version. Dense, packed and APEC, with and without
a carried map, `csr_stack` and rebalancing, against the single-device
dense product within 1e-5 (values and gradients); the report's per-shard
counts against `repro.runtime.sharding.per_shard_occupied_tiles` on the
same spikes; the ragged case's attribution and warnings.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro.launch.mesh import abstract_mesh as jabstract_mesh
from repro.models import lm as jlm
from repro.runtime import sharding as jrs
from repro_torch.configs import registry as treg
from repro_torch.core.events import EventTensor
from repro_torch.core.spikes import (pack_spikes_padded,
                                     shard_occupancy_to_csr, stack_shard_csrs)
from repro_torch.kernels import _build, dispatch, ops
from repro_torch.launch.mesh import abstract_mesh, make_mesh
from repro_torch.models import lm as tlm
from repro_torch.runtime import sharding as rs

torch.set_num_threads(1)
ATOL = 1e-5
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    dispatch.reset_fallback_warnings()


@functools.lru_cache(maxsize=None)
def _jabstract(arch: str, variant: str = ""):
    return jspecs.abstract_params(_cfgs(arch, variant)[0])


def _cfgs(arch: str, variant: str = ""):
    j, t = jreg.get_config(arch), treg.get_config(arch)
    if variant:
        j, t = j.replace(**{variant: True}), t.replace(**{variant: True})
    return j, t


def _jflat(tree):
    from jax.sharding import PartitionSpec as P
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jrs._path_str(p): tuple(spec) for p, spec in flat}


def _tflat(tree):
    return {path: tuple(spec) for path, spec in rs._spec_leaves(tree)}


def _assert_same_specs(jtree, ttree):
    want, got = _jflat(jtree), _tflat(ttree)
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for path, spec in want.items():
        assert got[path] == spec, (path, got[path], spec)


# ------------------------------------------------------------ spec trees
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
@pytest.mark.parametrize("mesh_id", sorted(MESHES))
def test_param_specs_equal_repro(arch, mesh_id):
    jcfg, tcfg = _cfgs(arch)
    shape, axes = MESHES[mesh_id]
    jmesh, tmesh = jabstract_mesh(shape, axes), abstract_mesh(shape, axes)
    jabs, tabs = _jabstract(arch), tlm.abstract_params(tcfg)
    assert all(x.device.type == "meta" for _, x in
               tlm._tree_leaves_with_path(tabs))
    jsp = jrs.param_specs(jcfg, jabs, jmesh)
    tsp = rs.param_specs(tcfg, tabs, tmesh)
    _assert_same_specs(jsp, tsp)
    assert not rs.validate_specs(tabs, tsp, tmesh)
    assert not jrs.validate_specs(jabs, jsp, jmesh)


@pytest.mark.parametrize("arch,variant", [
    ("mistral-large-123b", "tp2d"), ("qwen3-4b", "pure_fsdp"),
    ("tinyllama-1.1b", "fsdp"), ("qwen2-moe-a2.7b", "tp2d"),
    ("jamba-1.5-large-398b", "pure_fsdp"), ("xlstm-350m", "fsdp")])
def test_param_spec_variants_equal_repro(arch, variant):
    jcfg, tcfg = _cfgs(arch, variant)
    shape, axes = MESHES["16x16"]
    jmesh, tmesh = jabstract_mesh(shape, axes), abstract_mesh(shape, axes)
    jabs, tabs = _jabstract(arch, variant), tlm.abstract_params(tcfg)
    tsp = rs.param_specs(tcfg, tabs, tmesh)
    _assert_same_specs(jrs.param_specs(jcfg, jabs, jmesh), tsp)
    assert not rs.validate_specs(tabs, tsp, tmesh)


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
@pytest.mark.parametrize("spiking", [False, True], ids=["dense", "spiking"])
def test_decode_state_specs_equal_repro(arch, spiking):
    jcfg, tcfg = _cfgs(arch)
    shape, axes = MESHES["16x16"]
    jmesh, tmesh = jabstract_mesh(shape, axes), abstract_mesh(shape, axes)
    jstate = jax.eval_shape(functools.partial(
        jlm.init_decode_state, jcfg, 128, 1024, spiking))
    tstate = tlm.init_decode_state(tcfg, 128, 1024, spiking, device="meta")
    jsp = jrs.decode_state_specs(jcfg, jstate, jmesh)
    tsp = rs.decode_state_specs(tcfg, tstate, tmesh)
    _assert_same_specs(jsp, tsp)
    assert not rs.validate_specs(tstate, tsp, tmesh)


@pytest.mark.parametrize("b", [256, 32, 2, 1, 128, 8])
@pytest.mark.parametrize("mesh_id", sorted(MESHES))
def test_batch_axes_and_specs_equal_repro(b, mesh_id):
    shape, axes = MESHES[mesh_id]
    jmesh, tmesh = jabstract_mesh(shape, axes), abstract_mesh(shape, axes)
    assert rs.batch_axes(tmesh, b) == jrs.batch_axes(jmesh, b)
    assert rs.batch_axes(tmesh, b, True) == jrs.batch_axes(jmesh, b, True)
    for variant in ("", "pure_fsdp"):
        jcfg, tcfg = _cfgs("tinyllama-1.1b", variant)
        jb = {"tokens": jax.ShapeDtypeStruct((b, 64), jnp.int32),
              "frontend": jax.ShapeDtypeStruct((b, 4, 8), jnp.bfloat16)}
        tb = {"tokens": torch.empty((b, 64), device="meta"),
              "frontend": torch.empty((b, 4, 8), device="meta")}
        got = rs.batch_specs(tcfg, tb, tmesh)
        want = jrs.batch_specs(jcfg, jb, jmesh)
        assert {k: tuple(v) for k, v in got.items()} \
            == {k: tuple(v) for k, v in want.items()}


def test_named_records_specs_and_replicated():
    tcfg = treg.get_reduced("tinyllama-1.1b")
    mesh = make_mesh((2, 1), ("data", "model"), devices="cpu")
    sp = rs.param_specs(tcfg, tlm.abstract_params(tcfg), mesh)
    named = rs.named(mesh, sp)
    assert named["embed"] == rs.NamedSharding(mesh, sp["embed"])
    assert rs.replicated(mesh).spec == () and rs.model_size(mesh) == 1
    assert rs.P(("data",), None) == ("data", None)
    assert rs.P(("pod", "data"), None) == (("pod", "data"), None)


def test_validate_specs_flags_a_dim_smaller_than_its_shards():
    mesh = abstract_mesh((16, 16), ("data", "model"))
    tree = {"w": torch.empty((8, 64), device="meta")}
    problems = rs.validate_specs(tree, {"w": rs.P("model", None)}, mesh)
    assert problems == [(("w",), (8, 64), 0, "model", 16)]


# ---------------------------------------------------- sharded execution
@functools.lru_cache(maxsize=None)
def _mesh8():
    return make_mesh((8, 1), ("data", "model"), devices="cpu")


def _hot_band(rows=2048, k=256, seed=0, p=0.3):
    """Every event in the first quarter of the rows: the static split
    piles the occupied tiles on two of eight shards."""
    s = np.zeros((rows, k), np.float32)
    s[:rows // 4] = np.random.default_rng(seed).random((rows // 4, k)) < p
    return s


def _weights(k=256, n=64, seed=1):
    return torch.randn(k, n, generator=torch.Generator().manual_seed(seed))


def _close(got, want, scale=None):
    want = np.asarray(want)
    tol = ATOL * (np.abs(want).max() if scale is None else scale) + ATOL
    assert np.abs(np.asarray(got) - want).max() <= tol


CASES = [("spike_matmul", "cuda-pipe", False),
         ("spike_matmul", "cuda", False),
         ("spike_matmul", "cuda-packed-pipe", True),
         ("spike_matmul", "cuda-packed", True),
         ("apec_matmul", "cuda-pipe", False),
         ("apec_matmul", "cuda-packed-pipe", True)]


def _operand(s_np, packed):
    s = torch.from_numpy(s_np)
    if packed:
        return pack_spikes_padded(s), {"packed_k": s_np.shape[-1]}
    return s, {}


@pytest.mark.parametrize("op,backend,packed", CASES)
@pytest.mark.parametrize("source", ["carried", "rebalanced", "csr_stack",
                                    "rederived"])
def test_event_op_sharded_equals_the_dense_product(op, backend, packed,
                                                   source):
    s_np = _hot_band()
    w = _weights()
    want = s_np @ w.numpy()
    s, kw = _operand(s_np, packed)
    if op == "apec_matmul":
        kw["g"] = 2
    occ = ops.padded_occupancy(torch.from_numpy(s_np))
    call = dict(kw)
    if source in ("carried", "rebalanced"):
        call.update(occupancy=occ, rebalance=source == "rebalanced")
    if source == "csr_stack":
        if op != "spike_matmul":
            with pytest.raises(ValueError, match="pass-through"):
                rs.event_op_sharded(_mesh8(), op, s, w, csr_stack=object(),
                                    **kw)
            return
        call["csr_stack"] = stack_shard_csrs(shard_occupancy_to_csr(
            occ, 8, tiling=(128, 128)))
    with dispatch.use_backend(backend, op=op), \
            dispatch.watch_resolutions() as seen:
        out, rep = rs.event_op_sharded(_mesh8(), op, s, w, with_report=True,
                                       **call)
    assert len(seen) == 1 and seen[0]["attribution"] == backend
    assert rep["attribution"] == backend and rep["n_shards"] == 8
    assert rep["host_reads"] == 0
    assert rep["occupancy_source"] == {"rebalanced": "carried"}.get(
        source, source)
    _close(out.numpy(), want)
    imb = rep["occupancy"]
    rebalanced = source == "rebalanced" and op == "spike_matmul"
    assert bool(imb.pre_per_shard) == rebalanced
    if rebalanced:
        assert imb.imbalance < imb.pre_imbalance
        assert list(imb.pre_per_shard) == jrs.per_shard_occupied_tiles(
            jnp.asarray(s_np), 8)
    else:
        assert list(imb.per_shard) == jrs.per_shard_occupied_tiles(
            jnp.asarray(s_np), 8)


@pytest.mark.parametrize("op,backend,packed", CASES)
@pytest.mark.parametrize("rebalance", [False, True])
def test_event_op_sharded_gradients_equal_the_dense_ones(op, backend, packed,
                                                         rebalance):
    s_np = _hot_band(rows=1024, k=128, seed=2)
    w0 = _weights(128, 32, seed=3)
    g = torch.randn(1024, 32, generator=torch.Generator().manual_seed(4))
    want_dw = s_np.T @ g.numpy()
    want_ds = g.numpy() @ w0.numpy().T
    s, kw = _operand(s_np, packed)
    if op == "apec_matmul":
        kw["g"] = 2
    if not packed:
        s = s.clone().requires_grad_(True)
    w = w0.clone().requires_grad_(True)
    occ = ops.padded_occupancy(torch.from_numpy(s_np))
    with dispatch.use_backend(backend, op=op):
        out = rs.event_op_sharded(_mesh8(), op, s, w, occupancy=occ,
                                  rebalance=rebalance, **kw)
    (out * g).sum().backward()
    _close(w.grad.numpy(), want_dw)
    if not packed:
        _close(s.grad.numpy(), want_ds)


def test_event_tensor_carries_its_map_into_the_shards():
    """A packed EventTensor shards its words; a dense one its spikes; both
    use the carried map, with no dense pre-pass."""
    from repro_torch.core.spikes import (watch_occupancy_prepasses,
                                         watch_word_prepasses)
    s_np = _hot_band(seed=5)
    w = _weights()
    want = s_np @ w.numpy()
    for pack, backend in ((False, "cuda-pipe"), (True, "cuda-packed-pipe")):
        et = EventTensor.from_spikes(torch.from_numpy(s_np), pack=pack)
        with dispatch.use_backend(backend, op="spike_matmul"), \
                watch_occupancy_prepasses() as dense, \
                watch_word_prepasses() as words:
            out = rs.event_op_sharded(_mesh8(), "spike_matmul", et, w)
        assert dense["calls"] == 0 and words["calls"] == 0
        _close(out.numpy(), want)


def test_ragged_shard_grid_walks_the_chain_and_drops_the_map():
    """1536 rows over 8 shards = 192 rows a shard: the carried map is
    dropped (warned) and the CSR family degrades to the predicated kernel
    along the declared chain, as `repro`'s pallas-csr -> pallas."""
    s_np = _hot_band(rows=1536)
    w = _weights()
    s = torch.from_numpy(s_np)
    occ = ops.padded_occupancy(s)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        with dispatch.use_backend("cuda-pipe", op="spike_matmul"):
            out, rep = rs.event_op_sharded(_mesh8(), "spike_matmul", s, w,
                                           occupancy=occ, with_report=True)
    msgs = [str(r.message) for r in rec
            if issubclass(r.category, RuntimeWarning)]
    assert any("carried occupancy dropped" in m for m in msgs)
    assert any("per-shard rows 192" in m for m in msgs)
    assert rep["attribution"] == "cuda-pred<-cuda-pipe"
    assert rep["occupancy_source"] == "rederived"
    _close(out.numpy(), s_np @ w.numpy())


def test_csr_stack_off_the_family_is_ignored_with_a_warning():
    s_np = _hot_band(rows=1536)
    stack = stack_shard_csrs(shard_occupancy_to_csr(
        np.ones((12, 2), np.int32), 4))
    with dispatch.use_backend("cuda-pipe", op="spike_matmul"), \
            pytest.warns(RuntimeWarning, match="csr_stack ignored"):
        out = rs.event_op_sharded(_mesh8(), "spike_matmul",
                                  torch.from_numpy(s_np), _weights(),
                                  csr_stack=stack)
    _close(out.numpy(), s_np @ _weights().numpy())


def test_one_shard_and_automatic_cpu_resolution():
    """Rows that no batch axis divides run unsharded; on CPU tensors
    automatic selection lands on `ref`, as `repro`'s does on the CPU."""
    s_np = _hot_band(rows=1024)
    w = _weights()
    out, rep = rs.event_op_sharded(_mesh8(), "spike_matmul",
                                   torch.from_numpy(s_np)[:1020], w,
                                   with_report=True)
    assert rep["n_shards"] == 1 and rep["occupancy"] is None
    out2, rep2 = rs.event_op_sharded(_mesh8(), "spike_matmul",
                                     torch.from_numpy(s_np), w,
                                     with_report=True)
    assert rep2["attribution"] == "ref" and rep2["n_shards"] == 8
    _close(out2.numpy(), s_np @ w.numpy())
    with pytest.raises(ValueError, match="matmul-form"):
        rs.event_op_sharded(_mesh8(), "econv", out2, w)


def test_each_shard_launches_its_own_kernel(monkeypatch):
    """One wrapper call a shard, each on its own slice and work list: the
    pipelined wrapper counted as the card would count its launches."""
    from repro_torch.kernels import spike_matmul as csr
    calls = []
    plain = csr.spike_matmul_csr_pipe

    def counted(s2, w2, work):
        calls.append((s2.shape[0], work.n_rows))
        return plain(s2, w2, work)
    monkeypatch.setattr(csr, "spike_matmul_csr_pipe", counted)
    s_np = _hot_band()
    occ = ops.padded_occupancy(torch.from_numpy(s_np))
    with dispatch.use_backend("cuda-pipe", op="spike_matmul"):
        for rebalance in (False, True):
            calls.clear()
            rs.event_op_sharded(_mesh8(), "spike_matmul",
                                torch.from_numpy(s_np), _weights(),
                                occupancy=occ, rebalance=rebalance)
            assert calls == [(256, 2)] * 8
    assert not any(_build.LAUNCHES.values())


# ------------------------------------------------- the guard, per shard
GUARD_CASES = [("spike_matmul", "cuda-pipe", False, "carried"),
               ("spike_matmul", "cuda-pipe", False, "rebalanced"),
               ("spike_matmul", "cuda-pipe", False, "csr_stack"),
               ("spike_matmul", "cuda-packed-pipe", True, "carried"),
               ("spike_matmul", "cuda-packed-pipe", True, "csr_stack"),
               ("apec_matmul", "cuda-pipe", False, "carried")]


def _guard_call(op, packed, source, occ_bad):
    s_np = _hot_band(seed=6)
    w = _weights()
    s, kw = _operand(s_np, packed)
    if op == "apec_matmul":
        kw["g"] = 2
    bad = torch.from_numpy(occ_bad)
    if source == "csr_stack":
        kw["csr_stack"] = stack_shard_csrs(shard_occupancy_to_csr(
            bad, 8, tiling=(128, 128)))
    else:
        kw.update(occupancy=bad, rebalance=source == "rebalanced")
    return s_np, w, (lambda: rs.event_op_sharded(_mesh8(), op, s, w,
                                                 with_report=True, **kw))


def _undercount(seed=6, n_tiles=2):
    from repro_torch.runtime import faults
    occ = ops.padded_occupancy(torch.from_numpy(_hot_band(seed=seed)))
    bad, coords = faults.undercount_occupancy(occ.numpy(), n_tiles,
                                              seed=seed)
    assert coords and all(r < 4 for r, _ in coords)   # in the hot band
    return bad


@pytest.mark.parametrize("op,backend,packed,source", GUARD_CASES)
def test_sharded_call_under_audit_raises_on_a_host_undercount(
        op, backend, packed, source):
    """Every shard runs the guarded backend on its slice of the map (a
    `csr_stack` as the map its lists name): an undercount planted in a
    host map or in the caller's work lists raises, as unsharded."""
    _, _, call = _guard_call(op, packed, source, _undercount())
    with dispatch.use_backend(backend, op=op):
        with dispatch.use_guard("audit"), \
                dispatch.watch_guard_events() as ev, \
                pytest.raises(dispatch.GuardViolationError,
                              match="undercount"):
            call()
    assert [(e["op"], e["kind"], e["action"]) for e in ev] == \
        [(op, "undercount", "raise")]


@pytest.mark.parametrize("op,backend,packed,source", GUARD_CASES)
def test_sharded_call_under_repair_runs_on_the_payload(op, backend, packed,
                                                       source):
    s_np, w, call = _guard_call(op, packed, source, _undercount())
    want = s_np @ w.numpy()
    with dispatch.use_backend(backend, op=op):
        wrong, _ = call()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with dispatch.use_guard("repair"), \
                    dispatch.watch_guard_events() as ev:
                out, rep = call()
    assert np.abs(wrong.numpy() - want).max() > 1e-3    # the fault is real
    _close(out.numpy(), want)
    assert ev and {e["action"] for e in ev} == {"repair"}
    assert rep["occupancy_source"] == source.replace("rebalanced", "carried")
    assert bool(rep["occupancy"].pre_per_shard) == (source == "rebalanced")


@pytest.mark.parametrize("op,backend,packed,source", GUARD_CASES)
def test_sharded_call_under_audit_of_a_clean_map_is_unchanged(
        op, backend, packed, source):
    occ = ops.padded_occupancy(torch.from_numpy(_hot_band(seed=6))).numpy()
    _, _, call = _guard_call(op, packed, source, occ)
    with dispatch.use_backend(backend, op=op):
        plain, _ = call()
        with dispatch.use_guard("audit"), \
                dispatch.watch_guard_events() as ev:
            audited, _ = call()
    assert ev == [] and torch.equal(audited, plain)


@pytest.mark.parametrize("mode", ["audit", "repair"])
@pytest.mark.parametrize("packed", [False, True])
def test_sharded_call_on_a_card_map_takes_the_device_guard(monkeypatch,
                                                           mode, packed):
    """A map read as a card map: audit NaN-poisons the shards whose slice
    undercounts and leaves the others' rows as they were; repair gives the
    payload's product. Neither reads the map (no rebalancing by
    default)."""
    monkeypatch.setattr(dispatch, "_device_routed", lambda occ: True)
    monkeypatch.setattr(dispatch, "_platform", lambda args: "cuda")
    bad = _undercount()
    s_np, w, call = _guard_call("spike_matmul", packed, "carried", bad)
    want = s_np @ w.numpy()
    backend = "cuda-packed-pipe" if packed else "cuda-pipe"
    with dispatch.use_backend(backend, op="spike_matmul"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with dispatch.use_guard(mode):
            out, rep = _guard_call("spike_matmul", packed, "carried",
                                   bad)[2]()
    assert rep["host_reads"] == 0 and not rep["occupancy"].pre_per_shard
    per = 2048 // 8
    bad_shards = {r * 128 // per for r in np.argwhere(
        (bad == 0) & (ops.padded_occupancy(
            torch.from_numpy(s_np)).numpy() > 0))[:, 0]}
    if mode == "repair":
        _close(out.numpy(), want)
        return
    for i in range(8):
        rows = out[i * per:(i + 1) * per]
        if i in bad_shards:
            assert bool(rows.isnan().all())
        else:
            _close(rows.numpy(), want[i * per:(i + 1) * per])


def test_rebalance_reads_a_card_map_only_when_asked(monkeypatch):
    """By default a map on the card is not rebalanced (no host read, as
    `repro` leaves a traced map static); ``rebalance=True`` reads it once;
    shards of one tile row each are never planned, so nothing is read."""
    monkeypatch.setattr(dispatch, "_device_routed", lambda occ: True)
    w = _weights()
    with dispatch.use_backend("cuda-pipe", op="spike_matmul"):
        for rows, rebalance, reads, planned in ((2048, None, 0, False),
                                                (2048, True, 1, True),
                                                (2048, False, 0, False),
                                                (1024, True, 0, False)):
            s_np = _hot_band(rows=rows, seed=7)
            s = torch.from_numpy(s_np)
            out, rep = rs.event_op_sharded(
                _mesh8(), "spike_matmul", s, w, with_report=True,
                occupancy=ops.padded_occupancy(s), rebalance=rebalance)
            imb = rep["occupancy"]
            assert rep["host_reads"] == reads, (rows, rebalance)
            assert bool(imb.pre_per_shard) == planned, (rows, rebalance)
            if planned:
                assert imb.imbalance < imb.pre_imbalance
            _close(out.numpy(), s_np @ w.numpy())
