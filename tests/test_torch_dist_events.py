"""Sharded event execution with one shard a rank: `event_op_sharded` on
rank meshes of `gloo` processes on the CPU, against the port's
one-process form on a logical mesh of the same shards and against the
JAX package's `event_op_sharded` on four host devices.

Each rank passes its own rows of the spikes (dense, or packed words) and
its own slice of what comes with them: its rows of the carried map, or
its own entry of the caller's `csr_stack`. On the CPU every wrapper runs
its kernel's plain version, so each case pins the route the card takes
automatically (`cuda-pipe` / `cuda-packed-pipe`; `cuda-packed` for the
packed APEC product, whose pipelined kernel the reference runs only on
a TPU). Cases (`CASES`): dense and packed `spike_matmul` on a carried
map, static and rebalanced (the hot band in the first quarter of the
rows puts every event on shard 0, so the plan moves tile rows between
ranks); dense and packed on a `csr_stack`; `apec_matmul` dense and
packed; a ragged grid
(192 rows a rank: the map is dropped with the warning and the call
walks the chain to the predicated kernel); an audited call. Worlds of
four ranks ((4, 1), and the multi-pod (2, 2, 1) on a subset) and of two
((2, 1)).

Yardsticks: each rank's output rows bit for bit with the same rows of
the one-process call (one CPU thread on both sides) and within
1e-5·max|ref| of the reference's; every rank's report equal to the
one-process report (backend, attribution, shard count, source, reads,
bytes moved, per-shard counts before and after) and, through `NAME`, to
the reference's (backend, attribution, pre and post counts); the ranks'
summed weight gradient within 1e-5 relative of the one-process and the
reference's, and each rank's spike gradient its own rows of the
one-process one. Every spawn joins within SPAWN_TIMEOUT seconds; the
ranks import this module and never JAX.
"""
import contextlib
import functools
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.spikes import (pack_spikes_padded,
                                     shard_occupancy_to_csr, stack_shard_csrs)
from repro_torch.kernels import dispatch, ops
from repro_torch.launch import distributed
from repro_torch.launch.mesh import make_mesh, make_rank_mesh
from repro_torch.runtime import sharding

torch.set_num_threads(1)
SPAWN_TIMEOUT = 120
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, K, N, RAGGED_ROW = 1024, 256, 48, 192
TOL = 1e-5
# name -> (op, the port's backend, the reference's, packed, source)
CASES = {
    "dense_static": ("spike_matmul", "cuda-pipe",
                     "pallas-csr-pipe-interpret", False, "static"),
    "dense_rebalanced": ("spike_matmul", "cuda-pipe",
                         "pallas-csr-pipe-interpret", False, "rebalanced"),
    "packed_rebalanced": ("spike_matmul", "cuda-packed-pipe",
                          "packed-csr-pipe-interpret", True, "rebalanced"),
    "dense_csr_stack": ("spike_matmul", "cuda-pipe",
                        "pallas-csr-pipe-interpret", False, "csr_stack"),
    "packed_csr_stack": ("spike_matmul", "cuda-packed-pipe",
                         "packed-csr-pipe-interpret", True, "csr_stack"),
    "apec_dense": ("apec_matmul", "cuda-pipe", "pallas-csr-pipe-interpret",
                   False, "static"),
    "apec_packed": ("apec_matmul", "cuda-packed", "packed-csr-interpret",
                    True, "static"),
    "ragged": ("spike_matmul", "cuda-pipe", "pallas-csr-pipe-interpret",
               False, "ragged"),
    "dense_audited": ("spike_matmul", "cuda-pipe",
                      "pallas-csr-pipe-interpret", False, "audited"),
}
# The cases each rank mesh runs (the multi-pod mesh and the two-rank
# world a subset).
MESHES = {
    (4, 1): tuple(CASES),
    (2, 2, 1): ("dense_rebalanced", "packed_rebalanced", "dense_csr_stack"),
    (2, 1): ("dense_rebalanced", "packed_rebalanced", "apec_dense",
             "ragged"),
}
# repro's backend -> the port's
NAME = {"pallas-csr-pipe-interpret": "cuda-pipe",
        "packed-csr-pipe-interpret": "cuda-packed-pipe",
        "packed-csr-interpret": "cuda-packed",
        "pallas-interpret": "cuda-pred"}


def axes_of(shape) -> tuple:
    return ("pod", "data", "model") if len(shape) == 3 \
        else ("data", "model")


def n_ranks(shape) -> int:
    return int(np.prod(shape))


def rows_of(name, world) -> int:
    return RAGGED_ROW * world if CASES[name][4] == "ragged" else ROWS


def inputs() -> dict:
    """The seeded operands: spikes whose first quarter of the rows fires
    in every tile and the rest in the first 128 channels only (the
    static split loads shard 0 most), the weights and the output
    cotangent."""
    rng = np.random.default_rng(11)
    s = np.zeros((ROWS, K), np.float32)
    s[:ROWS // 4] = rng.random((ROWS // 4, K)) < 0.3
    s[ROWS // 4:, :128] = rng.random((3 * ROWS // 4, 128)) < 0.01
    return {"s": s, "w": rng.standard_normal((K, N)).astype(np.float32),
            "g": rng.standard_normal((ROWS, N)).astype(np.float32)}


def call_args(name, s_rows: np.ndarray, n_shards: int, own=None):
    """(payload, kwargs of `event_op_sharded`) of case `name` on the rows
    `s_rows`: the carried map of those rows, or the `csr_stack` of all
    shards (`own`: this rank's entry alone)."""
    op, backend, _, packed, source = CASES[name]
    s = torch.from_numpy(s_rows)
    occ = ops.padded_occupancy(s)
    kw = {"g": 2} if op == "apec_matmul" else {}
    payload = s
    if packed:
        payload = pack_spikes_padded(s)
        kw["packed_k"] = K
    if source == "csr_stack":
        kw["csr_stack"] = own if own is not None else stack_shard_csrs(
            shard_occupancy_to_csr(occ, n_shards, tiling=(128, 128)))
    else:
        kw.update(occupancy=occ, rebalance=source == "rebalanced")
    return payload, kw


@contextlib.contextmanager
def routed(name):
    op, backend, *_ = CASES[name]
    with contextlib.ExitStack() as stack:
        stack.enter_context(dispatch.use_backend(backend, op=op))
        if CASES[name][4] == "audited":
            stack.enter_context(dispatch.use_guard("audit"))
        warned = stack.enter_context(warnings.catch_warnings(record=True))
        warnings.simplefilter("always")
        dispatch.reset_fallback_warnings()
        yield warned


def run_case(mesh, name, payload, w, g, kw):
    """Output, report, dw, ds (None for packed words) and the warnings of
    one call, its backward against the cotangent `g`."""
    op = CASES[name][0]
    w = w.clone().requires_grad_(True)
    if payload.dtype == torch.float32:
        payload = payload.clone().requires_grad_(True)
    with routed(name) as warned:
        out, rep = sharding.event_op_sharded(mesh, op, payload, w,
                                             with_report=True, **kw)
    (out * g).sum().backward()
    return {"out": out.detach(), "rep": rep, "dw": w.grad,
            "ds": payload.grad if payload.requires_grad else None,
            "warned": sorted({str(x.message) for x in warned
                              if issubclass(x.category, RuntimeWarning)})}


# ------------------------------------------------------------ rank bodies
def world(world_size: int) -> dict:
    """Every case of every rank mesh of `world_size` ranks, on this rank:
    the rank's own rows in, its own rows out."""
    torch.set_num_threads(1)
    data = inputs()
    out = {}
    for shape, names in MESHES.items():
        if n_ranks(shape) != world_size:
            continue
        mesh = make_rank_mesh(shape, axes_of(shape))
        me = sharding.shard_index(mesh, tuple(
            a for a in ("pod", "data") if a in mesh.shape))
        for name in names:
            rows = rows_of(name, world_size)
            per = rows // world_size
            mine = slice(me * per, (me + 1) * per)
            own = None
            if CASES[name][4] == "csr_stack":
                own = shard_occupancy_to_csr(
                    ops.padded_occupancy(torch.from_numpy(
                        data["s"][:rows])), world_size,
                    tiling=(128, 128))[me]
            payload, kw = call_args(name, data["s"][:rows][mine],
                                    world_size, own)
            got = run_case(mesh, name, payload, torch.from_numpy(data["w"]),
                           torch.from_numpy(data["g"][:rows][mine]), kw)
            out[(shape, name)] = dict(got, rows=(mine.start, mine.stop))
    return out


# ---------------------------------------------------------------- the JAX
JAX_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0")
    import numpy as np, jax, jax.numpy as jnp
    from repro.core.spikes import shard_occupancy_to_csr, stack_shard_csrs
    from repro.kernels import dispatch, ops
    from repro.launch.mesh import make_mesh
    from repro.runtime import sharding
    inp = dict(np.load(sys.argv[1]))
    out = {}
    for name, op, backend, packed, source, rows, n in eval(sys.argv[3]):
        mesh = make_mesh((n, 1), ("data", "model"),
                         devices=jax.devices()[:n])
        s = jnp.asarray(inp["s"][:rows])
        g = jnp.asarray(inp["g"][:rows])
        occ = np.asarray(ops.padded_occupancy(s))
        kw = {"g": 2} if op == "apec_matmul" else {}
        payload = s
        if packed:
            payload = jnp.asarray(inp[f"words_{rows}"])
            kw["packed_k"] = s.shape[-1]
        if source == "csr_stack":
            kw["csr_stack"] = stack_shard_csrs(shard_occupancy_to_csr(
                jnp.asarray(occ), n, tiling=(128, 128)))
        else:
            kw.update(occupancy=jnp.asarray(occ),
                      rebalance=source == "rebalanced")

        reps = []

        def f(w_):
            # one call: its report (built from the concrete spikes and
            # map) kept aside, its output differentiated
            with dispatch.use_backend(backend, op=op):
                y, rep = sharding.event_op_sharded(
                    mesh, op, payload, w_, with_report=True, **kw)
            reps.append(rep)
            return y
        y, vjp = jax.vjp(f, jnp.asarray(inp["w"]))
        dw, = vjp(g)
        rep = reps[0]
        key = f"{name}|{n}"
        out[f"{key}|out"] = np.asarray(y)
        out[f"{key}|dw"] = np.asarray(dw)
        imb = rep["occupancy"]
        out[f"{key}|post"] = np.asarray(imb.per_shard)
        out[f"{key}|pre"] = np.asarray(imb.pre_per_shard or (-1,))
        out[f"{key}|names"] = np.asarray([rep["backend"],
                                          rep["attribution"]])
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """The worlds of 4 and 2 ranks beside the reference's calls on four
    host devices, run in a subprocess: (per world size, per rank; the
    JAX arrays)."""
    tmp = tmp_path_factory.mktemp("events")
    data = inputs()
    feed = {k: v for k, v in data.items()}
    jcases = []
    for n in (4,):
        for name in MESHES[(n, 1)]:
            op, _, jbackend, packed, source = CASES[name]
            if source == "audited":
                continue
            rows = rows_of(name, n)
            if packed:
                feed[f"words_{rows}"] = pack_spikes_padded(
                    torch.from_numpy(data["s"][:rows])).numpy()
            jcases.append((name, op, jbackend, packed, source, rows, n))
    feed_path, out_path = str(tmp / "in.npz"), str(tmp / "jax.npz")
    np.savez(feed_path, **feed)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_REFERENCE, feed_path, out_path,
         repr(jcases)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        worlds = {n: distributed.spawn(world, n, backend="gloo",
                                       device="cpu",
                                       timeout_s=SPAWN_TIMEOUT, args=(n,))
                  for n in (4, 2)}
        log, _ = jax_run.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, log[-3000:]
    return {"worlds": worlds, "jax": dict(np.load(out_path))}


@functools.lru_cache(maxsize=None)
def one_process(shape, name):
    """The one-process call on a logical mesh of the same shards, one CPU
    thread (the ranks' count)."""
    n = n_ranks(shape)
    data = inputs()
    rows = rows_of(name, n)
    payload, kw = call_args(name, data["s"][:rows], n)
    mesh = make_mesh(shape, axes_of(shape), devices="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_case(mesh, name, payload, torch.from_numpy(data["w"]),
                        torch.from_numpy(data["g"][:rows]), kw)
    finally:
        torch.set_num_threads(threads)


def combos() -> list:
    return [(shape, name) for shape, names in MESHES.items()
            for name in names]


def combo_id(combo) -> str:
    shape, name = combo
    return f"{name}-{'x'.join(map(str, shape))}"


def ranks_of(ranked, shape):
    return ranked["worlds"][n_ranks(shape)]


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("combo", combos(), ids=combo_id)
def test_each_ranks_rows_are_the_one_process_rows(ranked, combo):
    shape, name = combo
    want = one_process(shape, name)
    for r in ranks_of(ranked, shape):
        got = r[(shape, name)]
        rows = slice(*got["rows"])
        assert torch.equal(got["out"], want["out"][rows]), \
            f"{name} {shape}: off by " \
            f"{(got['out'] - want['out'][rows]).abs().max().item()}"
        if want["ds"] is not None:
            np.testing.assert_allclose(
                got["ds"], want["ds"][rows], rtol=0,
                atol=TOL * want["ds"].abs().max().item())
        assert got["warned"] == want["warned"]


@pytest.mark.parametrize("combo", combos(), ids=combo_id)
def test_every_rank_reports_the_one_process_report(ranked, combo):
    shape, name = combo
    want = one_process(shape, name)["rep"]
    for r in ranks_of(ranked, shape):
        assert r[(shape, name)]["rep"] == want
    source = CASES[name][4]
    assert want["n_shards"] == n_ranks(shape)
    assert (want["occupancy"].pre_per_shard != ()) == \
        (source == "rebalanced")
    assert (want["moved_bytes"] > 0) == (source == "rebalanced")
    if source == "ragged":
        assert want["attribution"] == "cuda-pred<-cuda-pipe"
        assert want["occupancy_source"] == "rederived"


@pytest.mark.parametrize("combo", combos(), ids=combo_id)
def test_summed_weight_gradient_is_the_one_process_one(ranked, combo):
    shape, name = combo
    want = one_process(shape, name)["dw"].numpy()
    got = sum(r[(shape, name)]["dw"].numpy()
              for r in ranks_of(ranked, shape))
    assert np.linalg.norm(got - want) <= TOL * np.linalg.norm(want)


@pytest.mark.parametrize("combo", [c for c in combos() if c[0] == (4, 1)
                                   and CASES[c[1]][4] != "audited"],
                         ids=combo_id)
def test_rank_form_matches_the_reference_sharded_call(ranked, combo):
    shape, name = combo
    n = shape[0]
    ranks = ranks_of(ranked, shape)
    jax_ref = ranked["jax"]
    key = f"{name}|{n}"
    want = jax_ref[f"{key}|out"]
    got = torch.cat([r[(shape, name)]["out"] for r in ranks]).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    dw = sum(r[(shape, name)]["dw"].numpy() for r in ranks)
    jdw = jax_ref[f"{key}|dw"]
    assert np.linalg.norm(dw - jdw) <= TOL * np.linalg.norm(jdw)
    rep = ranks[0][(shape, name)]["rep"]
    jbackend, jattr = (str(x) for x in jax_ref[f"{key}|names"])
    assert rep["backend"] == NAME[jbackend]
    assert rep["attribution"] == "<-".join(NAME[p]
                                           for p in jattr.split("<-"))
    imb = rep["occupancy"]
    assert list(imb.per_shard) == jax_ref[f"{key}|post"].tolist()
    assert list(imb.pre_per_shard or (-1,)) == \
        jax_ref[f"{key}|pre"].tolist()


def test_rank_mesh_runs_its_own_shard_on_its_device():
    """`RankMesh.shard_devices` is this rank's one device, whatever the
    axes (the one-process `shard_map` loop runs one shard on it)."""
    from repro_torch.launch.mesh import RankMesh
    mesh = RankMesh((2, 2), ("data", "model"), 3, torch.device("cpu"), {})
    assert mesh.shard_devices(("data",)) == (torch.device("cpu"),)
    assert mesh.shard_devices(("data", "model")) == (torch.device("cpu"),)
