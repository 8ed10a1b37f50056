"""The port's mesh and mesh-aware resolution against `repro`'s, on the CPU.

Mirrors `tests/test_mesh_dispatch.py` test by test on the port's
registry: per-shard gates, the degrade walk and its attribution, the
ambient `use_mesh`, the warn-once budget. Where a test names a backend,
the port's attribution is held to the reference's through `NAME`, the
port's counterpart of each `repro` backend (`cuda` for the serial CSR
family, `cuda-pred` for the predicated kernel). Mesh-aware resolution is a
function of shapes and the registry, so plain shard counts stand in for
meshes as in the reference.
"""
import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.launch import mesh as jmesh
from repro_torch.kernels import dispatch
from repro_torch.launch import mesh as tmesh

torch.set_num_threads(1)
CSR = "cuda"
JCSR = "pallas-csr-interpret"
# repro's backend -> the port's.
NAME = {"pallas-csr-interpret": "cuda", "pallas-interpret": "cuda-pred",
        "pallas-csr-pipe-interpret": "cuda-pipe",
        "packed-csr-interpret": "cuda-packed",
        "packed-csr-pipe-interpret": "cuda-packed-pipe",
        "ref": "ref", "jnp": "jnp", "hybrid": "hybrid"}


def _ported(attribution: str) -> str:
    """A `repro` attribution ``a<-b`` with each name mapped to the port's."""
    return "<-".join(NAME[p] for p in attribution.split("<-"))


@pytest.fixture(autouse=True)
def _fresh_dispatch_state(monkeypatch):
    for d in (dispatch, jdispatch):
        monkeypatch.delenv(d.ENV_VAR, raising=False)
        d.reset_fallback_warnings()


def _spikes(seed, shape, density=0.1):
    s = (np.random.default_rng(seed).random(shape) < density).astype(
        np.float32)
    return s, torch.from_numpy(s)


def _both(seed, shape, n, density=0.1):
    s_np, s = _spikes(seed, shape, density)
    return (jnp.asarray(s_np), jnp.zeros((shape[-1], n), jnp.float32),
            s, torch.zeros(shape[-1], n))


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


# ------------------------------------------------- resolution semantics
def test_mesh_resolution_keeps_csr_when_shards_tile_cleanly():
    js, jw, s, w = _both(0, (1024, 256), 64)
    with jdispatch.use_backend(JCSR, op="spike_matmul"):
        jattr = jdispatch.resolve_attribution("spike_matmul", js, jw, mesh=8)
    with dispatch.use_backend(CSR, op="spike_matmul"):
        assert dispatch.resolve_name("spike_matmul", s, w, mesh=8) == CSR
        assert dispatch.resolve_attribution("spike_matmul", s, w,
                                            mesh=8) == _ported(jattr) == CSR


def test_mesh_resolution_degrades_csr_on_ragged_shard_grids():
    # 512 rows / 8 shards = 64 < one 128-row tile per shard
    js, jw, s, w = _both(1, (512, 256), 64)
    with jdispatch.use_backend(JCSR, op="spike_matmul"), _quiet():
        jattr = jdispatch.resolve_attribution("spike_matmul", js, jw, mesh=8)
    with dispatch.use_backend(CSR, op="spike_matmul"):
        assert dispatch.resolve_name("spike_matmul", s, w) == CSR
        with pytest.warns(RuntimeWarning, match="per-shard rows"):
            assert dispatch.resolve_name("spike_matmul", s, w, mesh=8) \
                == "cuda-pred"
        assert dispatch.resolve_attribution("spike_matmul", s, w, mesh=8) \
            == f"cuda-pred<-{CSR}" == _ported(jattr)


def test_use_mesh_context_is_ambient_and_scoped():
    _, _, s, w = _both(2, (512, 256), 64)
    with dispatch.use_backend(CSR, op="spike_matmul"), _quiet():
        with dispatch.use_mesh(8):
            assert dispatch.ambient_mesh() == 8
            assert dispatch.resolve_name("spike_matmul", s, w) \
                == "cuda-pred"
        assert dispatch.ambient_mesh() is None
        assert dispatch.resolve_name("spike_matmul", s, w) == CSR


def test_non_mesh_aware_backend_is_refused_under_mesh():
    """econv's event scatter never declared `mesh_aware`: under a mesh an
    explicit override degrades it to ref (no declared fallback), as in
    `repro`."""
    args, kwargs = dispatch.example_inputs("econv", "cpu")
    jargs, jkw = jdispatch.example_inputs("econv", jax.random.PRNGKey(3))
    with jdispatch.use_backend("jnp", op="econv"), _quiet():
        jname = jdispatch.resolve_name("econv", *jargs, mesh=2, **jkw)
    with dispatch.use_backend("jnp", op="econv"):
        assert dispatch.resolve_name("econv", *args, **kwargs) == "jnp"
        with pytest.warns(RuntimeWarning, match="not declared mesh-aware"):
            assert dispatch.resolve_name("econv", *args, mesh=2,
                                         **kwargs) == dispatch.REF == jname


def test_mesh_auto_resolution_records_degrade_attribution():
    """resolved_backends under a mesh carries the `<-requested`
    attribution (the example shapes never fill a per-shard tile), and
    without a mesh the same override keeps the plain name."""
    with jdispatch.use_backend(JCSR, op="apec_matmul"), _quiet():
        jrb = jdispatch.resolved_backends(mesh=8)
    with dispatch.use_backend(CSR, op="apec_matmul"):
        rb = dispatch.resolved_backends("cpu", mesh=8)
        assert rb["apec_matmul"] == f"cuda-pred<-{CSR}" \
            == _ported(jrb["apec_matmul"])
        assert dispatch.resolved_backends("cpu")["apec_matmul"] == CSR


def test_data_shard_count_reads_batch_axes_only():
    for d, m in ((dispatch, tmesh), (jdispatch, jmesh)):
        assert d.data_shard_count(None) == 1
        assert d.data_shard_count(8) == 8
        assert d.data_shard_count(
            m.abstract_mesh((2, 2, 2), ("pod", "data", "model"))) == 4
        assert d.data_shard_count(
            m.abstract_mesh((4, 2), ("data", "model"))) == 4
        assert d.data_shard_count(m.abstract_mesh((4,), ("model",))) == 1
    # a concrete logical mesh of 8 data positions on one device
    assert dispatch.data_shard_count(tmesh.make_mesh(
        (8, 1), ("data", "model"), devices="cpu")) == 8


@pytest.mark.parametrize("op", ["spike_matmul", "apec_matmul", "econv",
                                "lif_scan", "sdsa", "tconv"])
def test_mesh_one_shard_is_plain_resolution(op):
    """A mesh of one data shard (or of `model` only) resolves exactly as
    no mesh does, automatic and under each override."""
    args, kwargs = dispatch.example_inputs(op, "cpu")
    meshes = (1, tmesh.abstract_mesh((4,), ("model",)),
              tmesh.make_host_mesh(device="cpu"))
    for name in (None,) + dispatch.backend_names(op):
        ctx = dispatch.use_backend(name, op=op) if name else \
            contextlib.nullcontext()
        with ctx, _quiet():
            flat = dispatch.resolve_attribution(op, *args, **kwargs)
            for m in meshes:
                assert dispatch.resolve_attribution(
                    op, *args, mesh=m, **kwargs) == flat, (name, m)


def test_mesh_one_shard_keeps_the_csr_override():
    _, _, s, w = _both(4, (512, 256), 64)
    with dispatch.use_backend(CSR, op="spike_matmul"):
        assert dispatch.resolve_name("spike_matmul", s, w, mesh=1) == CSR
        assert dispatch.resolve_name(
            "spike_matmul", s, w,
            mesh=tmesh.abstract_mesh((4,), ("model",))) == CSR


def test_dispatch_entry_accepts_mesh_and_matches_oracle():
    s_np, s = _spikes(5, (256, 128))
    w = torch.randn(128, 32, generator=torch.Generator().manual_seed(6))
    out = dispatch.dispatch("spike_matmul", s, w, mesh=2)
    np.testing.assert_allclose(out.numpy(), s_np @ w.numpy(), atol=1e-5)


def test_steps_factory_runs_under_mesh():
    """`launch.steps._under_mesh` pushes the ambient mesh around each call
    (the port resolves eagerly, per call), and is the identity without
    one."""
    from repro_torch.launch import steps as steps_mod
    seen = []

    def probe(x):
        seen.append(dispatch.ambient_mesh())
        return x

    wrapped = steps_mod._under_mesh(probe, 8)
    wrapped(torch.zeros(2))
    assert seen == [8] and dispatch.ambient_mesh() is None
    assert steps_mod._under_mesh(probe, None) is probe


# ------------------------------------------------------ warn-once dedup
def test_degrade_chain_warns_exactly_once_per_op_per_process():
    """The csr -> predicated degrade and the surrender to ref each warn
    ONCE per (op, from, to) per process, in both packages."""
    _, s = _spikes(7, (10, 32), 0.5)
    w = torch.zeros(32, 8)
    with dispatch.use_backend(CSR, op="apec_matmul"):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            for _ in range(3):
                dispatch.resolve("apec_matmul", s, w, g=3)
        msgs = [str(r.message) for r in rec
                if issubclass(r.category, RuntimeWarning)]
        assert len(msgs) == 2, msgs
        assert any("degrading to 'cuda-pred'" in m for m in msgs)
        assert any("falling back to 'ref'" in m for m in msgs)
        dispatch.reset_fallback_warnings()
        with warnings.catch_warnings(record=True) as rec2:
            warnings.simplefilter("always")
            dispatch.resolve("apec_matmul", s, w, g=3)
        assert len([r for r in rec2
                    if issubclass(r.category, RuntimeWarning)]) == 2


def test_mesh_degrade_warns_once_and_separately_from_flat_path():
    _, _, s, w = _both(8, (512, 256), 64)
    with dispatch.use_backend(CSR, op="spike_matmul"):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            for _ in range(4):
                dispatch.resolve("spike_matmul", s, w, mesh=8)
        msgs = [str(r.message) for r in rec
                if issubclass(r.category, RuntimeWarning)]
        assert len(msgs) == 1, msgs
        assert "per-shard rows" in msgs[0]
        with warnings.catch_warnings(record=True) as rec2:
            warnings.simplefilter("always")
            dispatch.resolve("spike_matmul", s, w)
        assert not rec2


def test_resolved_backends_snapshot_does_not_consume_warn_budget():
    _, _, s, w = _both(9, (512, 256), 64)
    with dispatch.use_backend(CSR, op="spike_matmul"):
        rb = dispatch.resolved_backends("cpu", mesh=8)
        assert rb["spike_matmul"] == f"cuda-pred<-{CSR}"
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            dispatch.resolve("spike_matmul", s, w, mesh=8)
        assert len([r for r in rec
                    if issubclass(r.category, RuntimeWarning)]) == 1


def test_per_shard_occupied_tiles_splits_spike_rows_not_tile_rows():
    """512 uniform rows over 8 shards: every 64-row shard pads to one
    occupied tile, as in `repro`."""
    from repro.runtime import sharding as jrs
    from repro_torch.runtime import sharding as rs
    s = torch.ones(512, 128)
    assert rs.per_shard_occupied_tiles(s, 8) == [1] * 8 \
        == jrs.per_shard_occupied_tiles(jnp.ones((512, 128)), 8)
    s2 = torch.zeros(1024, 128)
    s2[:128] = 1.0
    assert rs.per_shard_occupied_tiles(s2, 8) == [1] + [0] * 7


def test_event_op_sharded_rejects_csr_stack_for_other_ops():
    from repro_torch.core.spikes import (shard_occupancy_to_csr,
                                         stack_shard_csrs)
    from repro_torch.kernels import ops
    from repro_torch.runtime import sharding as rs
    _, s = _spikes(10, (256, 128))
    w = torch.zeros(128, 64)
    stack = stack_shard_csrs(shard_occupancy_to_csr(
        ops.padded_occupancy(s), 2, tiling=(128, 128)))
    mesh1 = tmesh.make_mesh((1, 1), ("data", "model"), devices="cpu")
    with pytest.raises(ValueError, match="spike_matmul pass-through"):
        rs.event_op_sharded(mesh1, "apec_matmul", s, w, g=2,
                            csr_stack=stack)


# ----------------------------------------- hybrid route-keyed warn-once
def test_hybrid_route_warn_not_suppressed_by_plain_degrade():
    from repro_torch.kernels import ops
    _, _, s, w = _both(30, (512, 256), 64)
    occ = ops.padded_occupancy(s)
    with dispatch.use_backend(CSR, op="spike_matmul"):
        with pytest.warns(RuntimeWarning, match="per-shard rows"):
            dispatch.resolve("spike_matmul", s, w, mesh=8)
    with dispatch.use_hybrid("spike_matmul"):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            for _ in range(3):
                be, attr = dispatch.resolve_with_attribution(
                    "spike_matmul", s, w, mesh=8, occupancy=occ)
        msgs = [str(r.message) for r in rec
                if issubclass(r.category, RuntimeWarning)]
        assert len(msgs) == 1, msgs
        assert "hybrid event route" in msgs[0]
        assert be.name == "cuda-pred"
        assert attr == f"cuda-pred<-{dispatch.HYBRID}"


def test_hybrid_route_warn_rearms_after_reset():
    from repro_torch.kernels import ops
    _, _, s, w = _both(31, (512, 256), 64)
    occ = ops.padded_occupancy(s)
    with dispatch.use_hybrid("spike_matmul"):
        with pytest.warns(RuntimeWarning, match="hybrid event route"):
            dispatch.resolve_with_attribution(
                "spike_matmul", s, w, mesh=8, occupancy=occ)
        dispatch.reset_fallback_warnings()
        with pytest.warns(RuntimeWarning, match="hybrid event route"):
            dispatch.resolve_with_attribution(
                "spike_matmul", s, w, mesh=8, occupancy=occ)


def test_occupancy_imbalance_carries_routes():
    from repro_torch.runtime.straggler import occupancy_imbalance
    imb = occupancy_imbalance([4, 0, 1], routes=("dense", "event", "event"))
    assert imb.routes == ("dense", "event", "event")
    assert "occ_routes=dense:event:event" in imb.as_fields()
    assert "occ_routes" not in occupancy_imbalance([4, 0, 1]).as_fields()


def test_event_op_sharded_reports_per_shard_hybrid_routes():
    """A skewed host map under hybrid on two logical positions: the report
    names each shard's route, the port's cost model (H100-calibrated) on
    each shard's occupied-tile count, the counts `repro` reports."""
    from repro.runtime import sharding as jrs
    from repro_torch.core import costmodel
    from repro_torch.kernels import ops
    from repro_torch.runtime import sharding as rs
    s_np = np.zeros((512, 256), np.float32)
    s_np[:256] = 1.0
    s_np[256, 0] = 1.0
    s = torch.from_numpy(s_np)
    mesh = tmesh.make_mesh((2, 1), ("data", "model"), devices="cpu")
    with dispatch.use_hybrid("spike_matmul"):
        out, rep = rs.event_op_sharded(mesh, "spike_matmul", s,
                                       torch.ones(256, 64),
                                       occupancy=ops.padded_occupancy(s),
                                       with_report=True)
    counts = jrs.per_shard_occupied_tiles(jnp.asarray(s_np), 2)
    assert counts == [4, 1] and list(rep["occupancy"].per_shard) == counts
    want = tuple("event" if costmodel.event_route_wins(
        "spike_matmul", costmodel.bucket_representative(
            costmodel.pow2_bucket(c), 4), 2, 2) else "dense" for c in counts)
    assert dispatch.HYBRID in rep["attribution"]
    assert rep["occupancy"].routes == want
    assert "occ_routes=" + ":".join(want) in rep["occupancy"].as_fields()
    np.testing.assert_allclose(out.numpy(), s_np @ np.ones((256, 64)),
                               atol=1e-5)


# ------------------------------------------------------------- the mesh
def test_mesh_factories_and_constants():
    m = tmesh.make_mesh((4, 2), ("data", "model"), devices="cpu")
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert tmesh.chips(m) == 8 and m.distinct_devices() == (
        torch.device("cpu"),)
    assert m.shard_devices(("data",)) == (torch.device("cpu"),) * 4
    a = tmesh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    j = jmesh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert a.devices is None and dict(a.shape) == dict(j.shape)
    host = tmesh.make_host_mesh(device="cpu")
    assert host.shape == {"data": 1, "model": 1}
    # the multi-pod mesh runs on ranks (tests/test_torch_dist_compress.py)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh(multi_pod=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_host_mesh()
        with pytest.raises(RuntimeError, match="devices='cpu'"):
            tmesh.make_mesh((2, 1), ("data", "model"))
    with pytest.raises(ValueError, match="3 devices"):
        tmesh.make_mesh((2, 1), ("data", "model"),
                        devices=["cpu"] * 3)
    assert tmesh.current_mesh() is None
    with tmesh.use_concrete_mesh(m):
        # one ambient stack: the registry resolves under the same mesh
        assert tmesh.current_mesh() is m and dispatch.ambient_mesh() is m
        with tmesh.use_concrete_mesh(None):
            assert tmesh.current_mesh() is m
    assert tmesh.current_mesh() is None
    with dispatch.use_mesh(m):
        assert tmesh.current_mesh() is m
    # H100 SXM data-sheet rates, not the TPU v5e's
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.PEAK_FLOPS_FP32,
            tmesh.PEAK_FLOPS_TF32, tmesh.HBM_BW) \
        == (989e12, 67e12, 495e12, 3.35e12)
    assert not hasattr(tmesh, "ICI_BW_PER_LINK")


def test_shard_map_runs_each_slice_and_concatenates_in_order():
    m = tmesh.make_mesh((4, 1), ("data", "model"), devices="cpu")
    calls = []

    def body(i, x, w, extra):
        calls.append((i, x.shape[0], extra))
        return x @ w + extra

    x = torch.arange(32.0).reshape(8, 4)
    w = torch.eye(4)
    out = tmesh.shard_map(body, mesh=m, axes=("data",),
                          shard_args=[(float(i),) for i in range(4)])(x, w)
    assert calls == [(i, 2, float(i)) for i in range(4)]
    want = x + torch.arange(4.0).repeat_interleave(2)[:, None]
    assert torch.equal(out, want)
    with pytest.raises(ValueError, match="equal shards"):
        tmesh.shard_map(body, mesh=m, axes=("data",))(x[:6], w)


def test_host_mesh_covers_the_cards_named(monkeypatch):
    """On a host of two cards (counted, not touched): ``"cuda"`` covers
    both, ``"cuda:1"`` that card alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    both = tmesh.make_host_mesh()
    assert both.shape == {"data": 2, "model": 1}
    assert both.distinct_devices() == (torch.device("cuda", 0),
                                       torch.device("cuda", 1))
    one = tmesh.make_host_mesh(device="cuda:1")
    assert one.shape == {"data": 1, "model": 1}
    assert one.distinct_devices() == (torch.device("cuda", 1),)
    assert dispatch.data_shard_count(one) == 1
