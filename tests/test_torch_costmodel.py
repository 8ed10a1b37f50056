"""The cost model: repro_torch.core.costmodel against repro's, on the CPU.

Every ported function is held to the JAX package's on a parameter grid:
integers, tuples and booleans exactly, floats within 1e-12 relative (the
same double arithmetic; only the order of a few sums may differ). The
ledgers take the port's route names (`cuda-pred`, `cuda`, `cuda-packed`
for repro's `pallas`, `pallas-csr`, `packed-csr`). The route model is
compared on shared calibration points, and the port's own table is held
to the committed H100 sweep it was transcribed from.
"""
import dataclasses
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costmodel as jcm
from repro_torch.core import costmodel as tcm

REPO = pathlib.Path(__file__).resolve().parent.parent
REL = 1e-12
ROUTE_NAMES = {"pallas": "cuda-pred", "pallas-csr": "cuda",
               "packed-csr": "cuda-packed"}


def _same(got, want, what=""):
    """Exact for ints, bools, strings and tuples of them; 1e-12 relative
    for floats; field by field for dataclasses and dicts."""
    if dataclasses.is_dataclass(want):
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, float) or isinstance(got, float):
        assert math.isclose(got, want, rel_tol=REL, abs_tol=0.0), \
            (what, got, want)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{what}[{i}]")
    else:
        assert got == want and type(got) is type(want), (what, got, want)


def _map(seed, mt, kt, p_live):
    rng = np.random.default_rng(seed)
    occ = rng.integers(1, 500, size=(mt, kt)).astype(np.int32)
    return occ * (rng.random((mt, kt)) < p_live)


MAPS = [(0, 4, 4, 0.5), (1, 3, 7, 0.2), (2, 8, 2, 0.0), (3, 5, 5, 1.0),
        (4, 1, 9, 0.3), (5, 16, 12, 0.1)]


# ---------------------------------------------------------- cycle model
@pytest.mark.parametrize("co,k,apec", [(32, 3, 0.0), (64, 3, 120.0),
                                       (100, 5, 7.5), (16, 1, 0.0)])
def test_conv_layer_cycles_match_jax(co, k, apec):
    args = ("conv", 1234.0, 456.0, 16, 16, 48, co, k)
    kw = dict(apec_group=2, apec_eliminated=apec,
              apec_overlap_positions=apec / 3)
    got = tcm.conv_layer_cycles(*args, **kw)
    want = jcm.conv_layer_cycles(*args, **kw)
    _same(got, want)
    _same(got.total, want.total)


@pytest.mark.parametrize("n_out", [10, 32, 33, 1536])
def test_fc_and_sdsa_cycles_match_jax(n_out):
    _same(tcm.fc_layer_cycles("fc", 777.0, 384, n_out),
          jcm.fc_layer_cycles("fc", 777.0, 384, n_out))
    _same(tcm.sdsa_cycles("ssa", n_out, 64), jcm.sdsa_cycles("ssa", n_out, 64))


@pytest.mark.parametrize("apec", [False, True])
def test_summarize_matches_jax(apec):
    def layers(cm):
        return [cm.conv_layer_cycles("c1", 5000.0, 900.0, 32, 32, 3, 48, 3),
                cm.fc_layer_cycles("fc", 800.0, 384, 1536),
                cm.sdsa_cycles("ssa", 64, 384)]
    _same(tcm.summarize(layers(tcm), apec=apec),
          jcm.summarize(layers(jcm), apec=apec))
    _same(tcm.ExSpikeHW(), jcm.ExSpikeHW())


# -------------------------------------------------------------- ledgers
@pytest.mark.parametrize("payload", ["dense", "packed"])
@pytest.mark.parametrize("block", [(128, 128), (64, 256), (8, 32)])
def test_spike_bytes_match_jax(payload, block):
    _same(tcm.spike_tile_bytes(*block, payload),
          jcm.spike_tile_bytes(*block, payload))
    _same(tcm.spike_payload_bytes(1000, 333, payload, 2),
          jcm.spike_payload_bytes(1000, 333, payload, 2))


def test_spike_bytes_refuse_what_jax_refuses():
    for cm in (tcm, jcm):
        with pytest.raises(ValueError, match="block_k % 32"):
            cm.spike_tile_bytes(128, 48, "packed")
        with pytest.raises(ValueError, match="unknown spike payload"):
            cm.spike_tile_bytes(128, 128, "sparse")
        with pytest.raises(ValueError, match="unknown spike payload"):
            cm.spike_payload_bytes(8, 8, "sparse")


@pytest.mark.parametrize("backend", list(ROUTE_NAMES))
@pytest.mark.parametrize("case", MAPS, ids=lambda c: "map%d" % c[0])
def test_tile_matmul_savings_match_jax(case, backend):
    occ = _map(*case)
    for n, payload in ((384, "dense"), (100, "packed")):
        got = tcm.tile_matmul_savings(occ, n, backend=ROUTE_NAMES[backend],
                                      payload=payload)
        want = jcm.tile_matmul_savings(occ, n, backend=backend,
                                       payload=payload)
        assert got.backend == ROUTE_NAMES[want.backend]
        _same(dataclasses.replace(got, backend=want.backend), want)
        _same(got.flops_fraction_saved, want.flops_fraction_saved)
        _same(got.dma_fraction_saved, want.dma_fraction_saved)


@pytest.mark.parametrize("backend", list(ROUTE_NAMES))
@pytest.mark.parametrize("case", MAPS, ids=lambda c: "map%d" % c[0])
def test_matmul_bytes_moved_match_jax(case, backend):
    occ = _map(*case)
    got = tcm.matmul_bytes_moved(occ, 1536, backend=ROUTE_NAMES[backend],
                                 block_n=64, out_bytes=2)
    want = jcm.matmul_bytes_moved(occ, 1536, backend=backend, block_n=64,
                                  out_bytes=2)
    assert got.backend == ROUTE_NAMES[want.backend]
    _same(dataclasses.replace(got, backend=want.backend), want)
    _same(got.total, want.total)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("backend", list(ROUTE_NAMES))
@pytest.mark.parametrize("case", MAPS, ids=lambda c: "map%d" % c[0])
def test_dma_overlap_ledger_matches_jax(case, backend, pipelined):
    occ = _map(*case)
    if backend == "pallas" and pipelined:
        for cm, name in ((tcm, "cuda-pred"), (jcm, "pallas")):
            with pytest.raises(ValueError, match="pipelined"):
                cm.dma_overlap_ledger(occ, 96, backend=name, pipelined=True)
        return
    got = tcm.dma_overlap_ledger(occ, 96, backend=ROUTE_NAMES[backend],
                                 pipelined=pipelined)
    want = jcm.dma_overlap_ledger(occ, 96, backend=backend,
                                  pipelined=pipelined)
    assert got.backend == ROUTE_NAMES[want.backend]
    _same(dataclasses.replace(got, backend=want.backend), want)
    _same(got.overlap_fraction, want.overlap_fraction)


def test_ledgers_refuse_unknown_routes():
    occ = _map(*MAPS[0])
    for fn in (tcm.tile_matmul_savings, tcm.matmul_bytes_moved,
               tcm.dma_overlap_ledger):
        with pytest.raises(ValueError, match="unknown tile-skipping"):
            fn(occ, 64, backend="pallas-csr")


# ---------------------------------------------------------- route model
GRIDS = [(4, 4), (2, 3), (8, 4), (64, 12), (1, 9), (64, 3)]


@pytest.mark.parametrize("mt,kt", GRIDS)
def test_route_step_costs_match_jax(mt, kt):
    for occupied in sorted({0, 1, 2, kt - 1, kt, mt * kt // 2,
                            mt * kt - kt, mt * kt - 1, mt * kt}):
        if occupied < 0:
            continue
        for r, h in ((0.02, 0.02), (1.3, 0.7), (20.0, 8.9)):
            _same(tcm.route_step_costs(occupied, mt, kt, r, h),
                  jcm.route_step_costs(occupied, mt, kt, r, h),
                  f"{occupied}/{mt}x{kt}")


def _points(seed, n=10):
    rng = np.random.default_rng(seed)
    occ = sorted(rng.choice(np.arange(0, 17), size=n, replace=False),
                 reverse=True)
    return tuple((int(o), float(rng.uniform(5, 50)), float(rng.uniform(5, 50)))
                 for o in occ)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_route_params_matches_jax(seed):
    pts = _points(seed)
    _same(tcm.fit_route_params(pts, 4, 4), jcm.fit_route_params(pts, 4, 4))


def test_fit_on_the_h100_sweep_matches_jax():
    """The same committed points give the same (r, h) in both packages,
    on the port's calibration grid."""
    for op in ("spike_matmul", "apec_matmul"):
        pts = tcm.ROUTE_CALIBRATION_POINTS[op]
        _same(tcm.fit_route_params(pts),
              jcm.fit_route_params(pts, tcm.CALIBRATION_TILES_M,
                                   tcm.CALIBRATION_TILES_K))


@pytest.mark.parametrize("total", [1, 4, 6, 16, 768, 4096])
def test_buckets_match_jax(total):
    _same(tcm.num_buckets(total), jcm.num_buckets(total))
    for b in range(tcm.num_buckets(total) + 1):
        _same(tcm.bucket_representative(b, total),
              jcm.bucket_representative(b, total))
    for c in range(0, min(total, 70) + 1):
        _same(tcm.pow2_bucket(c), jcm.pow2_bucket(c))


def test_pow2_bucket_traced_matches_jax_and_the_concrete_bucket():
    max_bits = (768).bit_length()
    counts = list(range(0, 70)) + [127, 128, 129, 255, 256, 511, 512, 767,
                                   768]
    got = tcm.pow2_bucket_traced(torch.tensor(counts, dtype=torch.int32),
                                 max_bits)
    assert got.dtype == torch.int32
    want = jax.jit(lambda x: jax.vmap(
        lambda c: jcm.pow2_bucket_traced(c, max_bits))(x))(
        jnp.asarray(counts, jnp.int32))
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist() == [tcm.pow2_bucket(c) for c in counts]
    assert int(tcm.pow2_bucket_traced(torch.tensor(5), max_bits)) == 3


@pytest.fixture
def shared_points(monkeypatch):
    """Both packages on the same calibration: the port's H100 points on
    the port's calibration grid (repro's `fit_route_params` defaults to
    its own 4 x 4 grid), with fresh fit caches."""
    for op in ("spike_matmul", "apec_matmul"):
        monkeypatch.setitem(jcm.ROUTE_CALIBRATION_POINTS, op,
                            tcm.ROUTE_CALIBRATION_POINTS[op])
    monkeypatch.setattr(jcm.fit_route_params, "__defaults__",
                        (tcm.CALIBRATION_TILES_M, tcm.CALIBRATION_TILES_K))
    jcm.calibrated_route_params.cache_clear()
    tcm.calibrated_route_params.cache_clear()
    yield
    jcm.calibrated_route_params.cache_clear()
    tcm.calibrated_route_params.cache_clear()


@pytest.mark.parametrize("op", ["spike_matmul", "apec_matmul", "econv"])
def test_route_table_and_threshold_match_jax(shared_points, op):
    _same(tcm.calibrated_route_params(op), jcm.calibrated_route_params(op))
    for mt, kt in GRIDS + [(1, 32), (8, 48), (16, 16)]:
        _same(tcm.hybrid_route_table(op, mt, kt),
              jcm.hybrid_route_table(op, mt, kt), f"{op} {mt}x{kt}")
        _same(tcm.hybrid_event_bucket_threshold(op, mt, kt),
              jcm.hybrid_event_bucket_threshold(op, mt, kt))
        for occupied in range(0, mt * kt + 1, max(1, mt * kt // 17)):
            _same(tcm.event_route_wins(op, occupied, mt, kt),
                  jcm.event_route_wins(op, occupied, mt, kt))


def test_econv_shares_spike_matmuls_fit():
    assert "econv" not in tcm.ROUTE_CALIBRATION_POINTS
    assert tcm.calibrated_route_params("econv") == \
        tcm.calibrated_route_params("spike_matmul")


# ----------------------------------------------------------- provenance
@pytest.mark.parametrize("op", ["spike_matmul", "apec_matmul"])
def test_calibration_points_are_the_committed_h100_sweep(op):
    """The embedded table IS the committed sweep of tools/route_sweep.py,
    re-derived from the file; the file names the card it ran on."""
    path = REPO / tcm.CALIBRATION_SWEEP
    assert tcm.crossover_points_from_sweep(str(path), op) == \
        tcm.ROUTE_CALIBRATION_POINTS[op]
    payload = json.loads(path.read_text())
    assert "H100" in payload["card"] and " W" in payload["card"]
    assert payload["tiles"] == [tcm.CALIBRATION_TILES_M,
                                tcm.CALIBRATION_TILES_K]
    sweeps = [s for s in payload["sweeps"] if s["op"] == op]
    assert len(sweeps) == 2                       # two sweeps per op
    total = tcm.CALIBRATION_TILES_M * tcm.CALIBRATION_TILES_K
    for sw in sweeps:      # one count a bucket, each the bucket's own
        counts = [p[0] for p in sw["points"]]
        assert counts == sorted({tcm.bucket_representative(b, total)
                                 for b in range(tcm.num_buckets(total))},
                                reverse=True)


def test_no_tpu_era_calibration_is_carried():
    """The port keeps neither the BENCH_PR3 crossover table nor the
    BENCH_PR7 bytes table, nor their parsers."""
    for name in ("PACKED_BYTES_POINTS", "crossover_points_from_bench",
                 "packed_bytes_points_from_bench"):
        assert not hasattr(tcm, name)
    for op, pts in tcm.ROUTE_CALIBRATION_POINTS.items():
        assert set(pts).isdisjoint(jcm.ROUTE_CALIBRATION_POINTS.get(op, ()))
