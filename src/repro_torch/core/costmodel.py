"""Analytic cost/cycle model of the ExSpike accelerator, the tile ledgers
of the port's spike matmuls, and the hybrid dense/event route model.

The cycle model (`ExSpikeHW` .. `sdsa_cycles`, `summarize`) is the
paper's FPGA: per-layer latency split into weight-ready / buffer /
calculation cycles (Fig. 8) and GOPS-style throughput (Table II), at the
paper's published configuration:

  * 200 MHz clock, 352 PEs (= 32 EPE clusters x (3x3 WPE + MPE + FPE)),
  * 32 output channels in parallel (one per cluster), reused over
    ceil(C_o / 32) groups (Algorithm 1, line 5),
  * one valid event filtered per cycle (Sparse Core),
  * weight fetch of C_o x k^2 bytes per unique event position.

"GOPS" follows the paper's convention of counting the dense-equivalent
synaptic operations retired per second.

The ledgers count what the port's kernels on the 128 x 128 tile grid pay
for one (M, K) x (K, N) spike matmul: grid steps, FLOPs, and the tile
bytes a block copies from global memory into shared memory, for the
predicated kernel (`cuda-pred`: every m-tile row walks all its k-tiles,
the map gates each product) and the event-compacted kernels (`cuda`,
`cuda-packed`: only the work list's occupied steps, plus one dummy step
per all-empty m-tile row).

The route model (`route_step_costs` .. `hybrid_event_bucket_threshold`)
is what hybrid dispatch (`kernels.dispatch.use_hybrid`) asks: at this
occupied-tile count, is the event route cheaper than the dense one? Its
two rates are fit on the H100 sweep that `tools/route_sweep.py` commits
as `tools/route_sweep_h100.json` (`ROUTE_CALIBRATION_POINTS`).

numpy and torch only; nothing here launches a kernel.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ExSpikeHW:
    clock_hz: float = 200e6
    n_clusters: int = 32          # parallel output channels
    wpe_per_cluster: int = 9      # 3x3 WPE units
    n_pe: int = 352               # 32 x (9 WPE + MPE + FPE)
    weight_bytes: int = 1         # 8-bit fixed-point weights
    mp_bytes: int = 2             # 16-bit membrane potentials
    weight_bw_bytes_per_cycle: int = 16   # Weight SRAM read port width
    power_w_baseline: float = 1.593       # Table I
    power_w_apec2: float = 1.700          # Table I


@dataclasses.dataclass
class LayerCycles:
    """Fig. 8 decomposition for one layer."""
    name: str
    weight: float      # waiting-for-weight-ready cycles
    buffer: float      # eFIFO/buffer cycles
    calc: float        # accumulation cycles
    events: float      # valid events executed
    dense_ops: float   # dense-equivalent synaptic ops (for GOPS)

    @property
    def total(self) -> float:
        return self.weight + self.buffer + self.calc


def conv_layer_cycles(
    name: str,
    n_events: float,
    n_unique_positions: float,
    h: int, w: int, ci: int, co: int, k: int,
    hw: ExSpikeHW = ExSpikeHW(),
    apec_group: int = 1,
    apec_eliminated: float = 0.0,
    apec_overlap_positions: float = 0.0,
) -> LayerCycles:
    """Cycle model of one EConv layer on the EPE Core.

    calc cycles: each event accumulates a k^2 patch across C_o channels;
    32 channels run in parallel, k^2 WPEs run in parallel, so an event
    costs ceil(C_o/32) cycles. APEC removes `apec_eliminated` events but
    adds overlap partial-sum reuse (buffer) and extra weight-ready traffic
    for overlap groups — the Fig. 8 trade-off.
    """
    groups = int(np.ceil(co / hw.n_clusters))
    exec_events = n_events - apec_eliminated
    calc = exec_events * groups
    # Weight fetch: per unique event position per group, a k^2 x 32-wide
    # weight block. APEC's overlap pass reuses the weight stream of the
    # group's first member, but the extra pass stalls the weight pipeline
    # at group boundaries: a 0.25-position penalty per overlapping group.
    wbytes_per_pos = k * k * hw.n_clusters * hw.weight_bytes
    weight_positions = n_unique_positions + 0.25 * apec_overlap_positions
    weight = weight_positions * groups * wbytes_per_pos / hw.weight_bw_bytes_per_cycle
    # Buffer: one eFIFO push per executed event + overlap psum cache traffic.
    buffer = exec_events * 0.125 + apec_overlap_positions * k * k / hw.wpe_per_cluster
    dense_ops = 2.0 * h * w * k * k * ci * co   # MAC = 2 ops, dense equivalent
    return LayerCycles(name, weight, buffer, calc, exec_events, dense_ops)


def fc_layer_cycles(
    name: str, n_events: float, n_in: int, n_out: int,
    hw: ExSpikeHW = ExSpikeHW(),
) -> LayerCycles:
    """EAFC Core: one weight-row accumulate per event (Sec. III-B)."""
    groups = int(np.ceil(n_out / hw.n_clusters))
    calc = n_events * groups
    weight = n_events * groups * hw.n_clusters * hw.weight_bytes / hw.weight_bw_bytes_per_cycle
    return LayerCycles(name, weight, calc * 0.125, calc, n_events, 2.0 * n_in * n_out)


def sdsa_cycles(
    name: str, n_tokens: int, d: int, hw: ExSpikeHW = ExSpikeHW()
) -> LayerCycles:
    """Attention Core: stage-1 AND/OR on the fly with V write-back, stage-2
    AND per Q row; d bits per cycle across clusters."""
    lanes = hw.n_clusters * hw.wpe_per_cluster * 32  # bit-parallel logic lanes
    stage1 = n_tokens * d / lanes
    stage2 = n_tokens * d / lanes
    dense_ops = 2.0 * n_tokens * n_tokens * d        # softmax-attn equivalent
    return LayerCycles(name, 0.0, stage1, stage2, n_tokens * d, dense_ops)


def summarize(layers: list[LayerCycles], hw: ExSpikeHW = ExSpikeHW(),
              apec: bool = False) -> dict:
    """Network-level Table II style metrics."""
    cycles = sum(l.total for l in layers)
    ops = sum(l.dense_ops for l in layers)
    latency_s = cycles / hw.clock_hz
    gops = ops / latency_s / 1e9 if latency_s > 0 else 0.0
    power = hw.power_w_apec2 if apec else hw.power_w_baseline
    return {
        "cycles": cycles,
        "latency_ms": latency_s * 1e3,
        "fps": 1.0 / latency_s if latency_s > 0 else 0.0,
        "gops": gops,
        "gops_per_w": gops / power,
        "gops_per_w_per_pe": gops / power / hw.n_pe,
        "total_events": sum(l.events for l in layers),
    }


# ------------------------------------------------------------ the ledgers
# Backend names of the ledgers: the port's routes of `spike_matmul`.
PRED = "cuda-pred"        # predicated: every k-tile of a row visited
EVENT = "cuda"            # event-compacted work list, f32 spikes
PACKED = "cuda-packed"    # the same work list on uint32 words
_EVENT_ROUTES = (EVENT, PACKED)


@dataclasses.dataclass(frozen=True)
class TileSkipSavings:
    """What a tile-skipping spike-matmul route saves, with the FLOP ledger
    and the copy ledger kept apart, since the routes differ in which they
    pay out:

      * the predicated kernel (`cuda-pred`) saves the FLOPs of empty
        tiles, but its grid counts every step, and the ledger charges it
        every spike and weight tile's copy into shared memory;
      * the event-compacted kernels (`cuda`, `cuda-packed`) save the same
        FLOPs AND the tile copies, because empty tiles never enter the
        work list (dummy steps for all-empty rows are the only residue).
    """
    backend: str
    grid_steps_total: int     # dense grid: MT*KT steps per output N-tile
    grid_steps_run: int
    flops_total: float        # dense-equivalent flops
    flops_saved: float
    dma_bytes_total: float    # spike + weight tile copies, global -> shared
    dma_bytes_saved: float

    @property
    def flops_fraction_saved(self) -> float:
        return self.flops_saved / self.flops_total if self.flops_total else 0.0

    @property
    def dma_fraction_saved(self) -> float:
        return self.dma_bytes_saved / self.dma_bytes_total \
            if self.dma_bytes_total else 0.0


PACK = 32                 # channels per uint32 spike word (core.spikes.PACK)
PACK_WORD_BYTES = 4


def spike_tile_bytes(block_m: int, block_k: int, payload: str = "dense",
                     spike_bytes: int = 4) -> float:
    """Global-memory bytes of one (block_m, block_k) spike tile in
    `payload` form.

    "dense": block_k elements of `spike_bytes` each (the f32 route).
    "packed": block_k/32 uint32 words, the 32x compression the word
    kernels read instead. block_k must stay a multiple of 32.
    """
    if payload == "packed":
        if block_k % PACK:
            raise ValueError(f"packed tile needs block_k % {PACK} == 0, "
                             f"got {block_k}")
        return float(block_m * (block_k // PACK) * PACK_WORD_BYTES)
    if payload != "dense":
        raise ValueError(f"unknown spike payload {payload!r}")
    return float(block_m * block_k * spike_bytes)


def spike_payload_bytes(rows: int, k: int, payload: str = "dense",
                        spike_bytes: int = 4) -> float:
    """One materialization of a (rows, k) spike tensor in global memory,
    what the producing fire writes (and a re-deriving pre-pass reads
    back). Packed emission writes ceil(k/32) uint32 words per row."""
    if payload == "packed":
        return float(rows) * (-(-k // PACK)) * PACK_WORD_BYTES
    if payload != "dense":
        raise ValueError(f"unknown spike payload {payload!r}")
    return float(rows) * k * spike_bytes


def _grid(occupancy, n: int, block_n: int):
    """(mt, kt, nt, occupied tiles, all-empty m-tile rows) of a map."""
    occ = np.asarray(occupancy)
    mt, kt = occ.shape
    nt = int(np.ceil(n / block_n))
    occupied = int(np.count_nonzero(occ > 0))
    empty_rows = int(np.sum(~(occ > 0).any(axis=1)))
    return mt, kt, nt, occupied, empty_rows


def _steps_run(backend: str, mt: int, kt: int, nt: int, occupied: int,
               empty_rows: int) -> int:
    if backend == PRED:
        return mt * kt * nt
    if backend in _EVENT_ROUTES:
        return (occupied + empty_rows) * nt
    raise ValueError(f"unknown tile-skipping backend {backend!r}")


def tile_matmul_savings(
    occupancy: "np.ndarray",
    n: int,
    *,
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
    spike_bytes: int = 4,
    weight_bytes: int = 4,
    backend: str = PRED,
    payload: str = "dense",
) -> TileSkipSavings:
    """FLOPs saved against tile copies saved for one (M, K) x (K, N) spike
    matmul.

    `occupancy`: the (MT, KT) per-tile event-count map the kernels consume
    (`core.spikes.tile_occupancy`). `backend`: "cuda-pred" (predicated),
    "cuda" (event-compacted) or "cuda-packed" (the same work list on
    uint32 words — implies payload="packed"). The event accounting
    charges one dummy step per all-empty m-tile row, whose output block
    must still be written.

    `payload` prices each step's spike tile (dense elements or packed
    words). The saved FRACTION is payload-invariant (total and saved scale
    together); the absolute dma_bytes_* differ 32x on the spike side.
    """
    if backend == PACKED:
        payload = "packed"
    mt, kt, nt, occupied, empty_rows = _grid(occupancy, n, block_n)
    empty = mt * kt - occupied
    per_tile_flops = 2.0 * block_m * block_k * block_n
    per_step_dma = (spike_tile_bytes(block_m, block_k, payload, spike_bytes)
                    + block_k * block_n * weight_bytes)
    steps_total = mt * kt * nt
    steps_run = _steps_run(backend, mt, kt, nt, occupied, empty_rows)
    return TileSkipSavings(
        backend=backend,
        grid_steps_total=steps_total,
        grid_steps_run=steps_run,
        flops_total=steps_total * per_tile_flops,
        flops_saved=empty * nt * per_tile_flops,    # every route skips them
        dma_bytes_total=steps_total * per_step_dma,
        dma_bytes_saved=0.0 if backend == PRED
        else (steps_total - steps_run) * per_step_dma,
    )


# Bytes-moved ledger: absolute global-memory traffic per op, packed vs
# f32. The copy ledger above answers "what fraction of this route's own
# tile traffic does compaction save"; this one how many bytes move, in
# each payload. Three components are kept apart, because only one
# responds to packing:
#
#   spike_hbm  — spike tile reads (steps_run x spike tile bytes): the
#                traffic event compression acts on, 32x down on words;
#   weight_hbm — weight tile reads, the same for both payloads (the word
#                and f32 kernels walk the same work list);
#   out_hbm    — output tile writes (mt x nt tiles, once each).
@dataclasses.dataclass(frozen=True)
class BytesMoved:
    """Modeled global-memory traffic of one matmul-form op call."""
    backend: str
    payload: str
    spike_hbm: float     # spike tile reads (the compressible stream)
    weight_hbm: float    # weight tile reads (payload-invariant)
    out_hbm: float       # output tile writes (payload-invariant)

    @property
    def total(self) -> float:
        return self.spike_hbm + self.weight_hbm + self.out_hbm


def matmul_bytes_moved(
    occupancy: "np.ndarray",
    n: int,
    *,
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
    backend: str = EVENT,
    payload: str = "dense",
    spike_bytes: int = 4,
    weight_bytes: int = 4,
    out_bytes: int = 4,
) -> BytesMoved:
    """Modeled global-memory bytes in and out of one (M, K) x (K, N) spike
    matmul: the grid accounting of `tile_matmul_savings`, the spike stream
    priced in its payload ("cuda-packed" forces payload="packed")."""
    if backend == PACKED:
        payload = "packed"
    mt, kt, nt, occupied, empty_rows = _grid(occupancy, n, block_n)
    steps_run = _steps_run(backend, mt, kt, nt, occupied, empty_rows)
    return BytesMoved(
        backend=backend,
        payload=payload,
        spike_hbm=steps_run * spike_tile_bytes(block_m, block_k, payload,
                                               spike_bytes),
        weight_hbm=float(steps_run) * block_k * block_n * weight_bytes,
        out_hbm=float(mt * nt) * block_m * block_n * out_bytes,
    )


@dataclasses.dataclass(frozen=True)
class DmaOverlap:
    """How much of one op call's weight-tile copying hides behind compute.

    The serial event kernels stage the weight tile of step t as part of
    step t: every weight byte is on the critical path (`bytes_stalled`).
    The pipelined kernels (`pipelined=True`, the cp.async ring) start the
    copy for occupied step t+1 while step t computes, so only the warm-up
    copy of each N-tile iteration is exposed (`bytes_prefetched` is the
    rest). Dummy steps copy nothing under pipelining, while the serial
    ledger still charges them.
    """
    backend: str
    pipelined: bool
    bytes_total: float        # weight bytes copied across the whole grid
    bytes_prefetched: float   # started >= 1 step before their product
    bytes_stalled: float      # exposed: compute waits on the copy

    @property
    def overlap_fraction(self) -> float:
        return (self.bytes_prefetched / self.bytes_total
                if self.bytes_total else 0.0)


def dma_overlap_ledger(
    occupancy: "np.ndarray",
    n: int,
    *,
    block_k: int = 128,
    block_n: int = 128,
    backend: str = EVENT,
    pipelined: bool = False,
    weight_bytes: int = 4,
) -> DmaOverlap:
    """The prefetched/stalled split of weight-tile copies for one call.

    Grid accounting of `matmul_bytes_moved` (occupied steps plus one dummy
    per all-empty m-tile row for the event routes, times the N-tile count):

      * serial: every step's weight copy is exposed, dummies included;
      * pipelined: occupied steps copy, dummy steps copy nothing, and
        exactly one warm-up copy per N-tile iteration is exposed.

    For APEC pass the union map (`(occ_res > 0) | (occ_ov > 0)` as
    counts): the ring copies when either operand will compute.
    """
    mt, kt, nt, occupied, empty_rows = _grid(occupancy, n, block_n)
    tile_bytes = float(block_k * block_n * weight_bytes)
    if backend == PRED:
        if pipelined:
            raise ValueError("pipelined variants exist only for the event "
                             "routes")
        fetches = mt * kt * nt
        prefetched = 0
    elif backend in _EVENT_ROUTES:
        if pipelined:
            fetches = occupied * nt
            prefetched = max(0, fetches - (nt if occupied else 0))
        else:
            fetches = (occupied + empty_rows) * nt
            prefetched = 0
    else:
        raise ValueError(f"unknown tile-skipping backend {backend!r}")
    total = fetches * tile_bytes
    pre = prefetched * tile_bytes
    return DmaOverlap(
        backend=backend, pipelined=pipelined, bytes_total=total,
        bytes_prefetched=pre, bytes_stalled=total - pre)


# ------------------------------------------------------ the route model
# Hybrid dispatch needs a predicate: given the carried map's occupied-tile
# count, is the event route (`cuda`: the work list's live steps only) cheaper
# than the predicated dense route (`cuda-pred`: every k-tile of every row
# visited, the map gating each product)? In units of one grid step's tile
# copy, dense runs every step and computes only on occupied ones; event
# runs occupied steps plus one dummy per all-empty m-tile row, at a
# per-step overhead. Two unknowns are machine-relative rates:
#
#   r — the product of one occupied step, in units of one step's copy
#   h — the event route's overhead a step, same units
#
# Both are fit on the H100 sweep in `tools/route_sweep_h100.json`
# (`fit_route_params` on `ROUTE_CALIBRATION_POINTS`). The structure is the
# reference's, shaped by the TPU's grid, where the predicated kernel
# copies every tile. On the H100 kernel 10 copies nothing of an empty
# k-tile and the event route pays a fixed work-list build, so the sweep
# runs the other way (dense faster on sparse maps, the walk on full ones)
# and the fit mispredicts the points `tools/route_sweep.py` lists.

# The sweep's tile grid: SpikingFormer-4-384's FFN fc2 at T=4, B=32,
# (8192 x 1536) x (1536 x 384) on 128 x 128 tiles.
CALIBRATION_TILES_M = 64
CALIBRATION_TILES_K = 12
CALIBRATION_N = 384
CALIBRATION_SWEEP = "tools/route_sweep_h100.json"

# (occupied_tiles, t_dense_us, t_event_us) per op, transcribed from the two
# sweeps of `tools/route_sweep.py` committed in tools/route_sweep_h100.json
# (`cuda-pred` against `cuda` on the card named there; APEC at g = 2).
# tests/test_torch_costmodel.py asserts this table equals
# `crossover_points_from_sweep(CALIBRATION_SWEEP, op)`.
ROUTE_CALIBRATION_POINTS: dict[str, tuple[tuple[int, float, float], ...]] = {
    "spike_matmul": (
        (768, 822.356, 591.948), (384, 511.242, 509.946),
        (192, 267.398, 332.271), (96, 121.34, 225.714), (48, 92.267, 165.831),
        (24, 63.834, 159.86), (12, 91.977, 165.255), (6, 36.182, 118.389),
        (3, 35.675, 118.734), (1, 32.674, 102.499), (0, 7.737, 79.338),
        (768, 823.127, 590.699), (384, 457.006, 445.549),
        (192, 245.025, 332.987), (96, 121.709, 207.655), (48, 92.367, 202.522),
        (24, 121.03, 189.334), (12, 35.911, 118.275), (6, 35.826, 118.013),
        (3, 35.96, 117.262), (1, 35.857, 102.595), (0, 7.843, 76.414),
    ),
    "apec_matmul": (
        (768, 1294.85, 569.666), (384, 969.71, 477.806),
        (192, 643.907, 320.146), (96, 405.609, 234.082),
        (48, 339.195, 215.942), (24, 237.722, 183.27), (12, 277.418, 199.417),
        (6, 177.579, 164.844), (3, 143.014, 165.354), (1, 144.295, 164.614),
        (0, 79.292, 147.581), (768, 1296.246, 569.008), (384, 929.84, 427.077),
        (192, 620.272, 320.143), (96, 374.96, 234.648), (48, 308.551, 202.789),
        (24, 319.495, 218.113), (12, 173.743, 165.484), (6, 145.653, 165.134),
        (3, 145.125, 165.169), (1, 140.239, 165.002), (0, 78.943, 146.702),
    ),
}


def crossover_points_from_sweep(path: str, op: str,
                                ) -> tuple[tuple[int, float, float], ...]:
    """Re-derive (occupied_tiles, t_dense_us, t_event_us) for `op` from a
    committed sweep (`tools/route_sweep.py`'s JSON): every sweep of `op`
    in file order, its points as written — the provenance check for
    ROUTE_CALIBRATION_POINTS."""
    with open(path) as f:
        payload = json.load(f)
    points: list[tuple[int, float, float]] = []
    for sweep in payload["sweeps"]:
        if sweep["op"] != op:
            continue
        for occupied, t_dense, t_event in sweep["points"]:
            points.append((int(occupied), float(t_dense), float(t_event)))
    return tuple(points)


@functools.lru_cache(maxsize=None)
def _expected_empty_rows(occupied: int, mt: int, kt: int) -> float:
    """Expected all-empty m-tile rows when `occupied` tiles land uniformly
    on an (mt, kt) map (the sweep's generator places exactly that many
    live tiles at random). Each empty row costs the event route a dummy
    step (tile_matmul_savings charges the same)."""
    total = mt * kt
    occupied = max(0, min(int(occupied), total))
    if occupied > total - kt:
        return 0.0
    return mt * math.comb(total - kt, occupied) / math.comb(total, occupied)


def route_step_costs(occupied: int, mt: int, kt: int,
                     r: float, h: float) -> tuple[float, float]:
    """(dense_cost, event_cost) of one matmul-form call, in units of one
    grid step's tile copy. The structural accounting of
    `tile_matmul_savings` (per output N-tile, so nt cancels):

      dense: every one of the mt*kt steps copies its tiles; only the
             `occupied` steps compute (r each).
      event: only occupied steps plus the all-empty-row dummies run, each
             paying its copy + the overhead h; dummies compute nothing.
    """
    dummies = _expected_empty_rows(occupied, mt, kt)
    dense = mt * kt + r * occupied
    event = occupied * (1.0 + r + h) + dummies * (1.0 + h)
    return dense, event


def fit_route_params(points: tuple[tuple[int, float, float], ...],
                     mt: int = CALIBRATION_TILES_M,
                     kt: int = CALIBRATION_TILES_K) -> tuple[float, float]:
    """Fit (r, h) by coarse log-grid least squares on the *ratio*
    event/dense (ratios cancel the unknown us-per-step scale, so the two
    timing sweeps calibrate two unitless rates)."""
    grid = np.geomspace(0.02, 20.0, 61)
    best = (math.inf, 1.0, 1.0)
    for r in grid:
        for h in grid:
            err = 0.0
            for occupied, t_dense, t_event in points:
                dense, event = route_step_costs(occupied, mt, kt, r, h)
                err += (math.log(event / dense)
                        - math.log(t_event / t_dense)) ** 2
            if err < best[0]:
                best = (err, float(r), float(h))
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def calibrated_route_params(op: str) -> tuple[float, float]:
    """(r, h) for `op`; econv shares spike_matmul's calibration (it lowers
    to the same spike-matmul tile grids via im2col)."""
    points = ROUTE_CALIBRATION_POINTS.get(op)
    if points is None:
        points = ROUTE_CALIBRATION_POINTS["spike_matmul"]
    return fit_route_params(points)


def event_route_wins(op: str, occupied: int, mt: int, kt: int) -> bool:
    """The hybrid predicate: does the event route cost less than the
    predicated dense route at this occupied-tile count?"""
    r, h = calibrated_route_params(op)
    dense, event = route_step_costs(occupied, mt, kt, r, h)
    return event < dense


# pow2 occupancy buckets, the idiom of the work lists' step caps:
# bucket(c) = bit_length(c): 0 | 1 | 2-3 | 4-7 | 8-15 | ..., so a map
# shape has at most bit_length(mt*kt)+1 routes, never one per count.
def pow2_bucket(count: int) -> int:
    """Band index of an occupied-tile count (a Python int)."""
    return int(count).bit_length()


def pow2_bucket_traced(count: torch.Tensor, max_bits: int) -> torch.Tensor:
    """bit_length of a count tensor, on its device and without reading it
    on the host: #{i < max_bits : count >= 2**i}, an int32 tensor of
    count's shape. `max_bits` (total_tiles.bit_length()) keeps the result
    in range."""
    thresholds = 2 ** torch.arange(max_bits, dtype=torch.int64,
                                   device=count.device)
    return (count.to(torch.int64)[..., None] >= thresholds).sum(
        dim=-1, dtype=torch.int32)


def num_buckets(total_tiles: int) -> int:
    return int(total_tiles).bit_length() + 1


def bucket_representative(bucket: int, total_tiles: int) -> int:
    """Midpoint-ish count of band `bucket` (0, 1, 3, 6, 12, ...), clamped
    to the map's tile total — the count the predicate is asked about on
    behalf of the whole band."""
    return min(int(total_tiles), (3 << bucket) >> 2)


def hybrid_route_table(op: str, mt: int, kt: int) -> tuple[bool, ...]:
    """Per-bucket route choice for an (mt, kt) map: True = event route."""
    total = mt * kt
    return tuple(
        event_route_wins(op, bucket_representative(b, total), mt, kt)
        for b in range(num_buckets(total)))


def hybrid_event_bucket_threshold(op: str, mt: int, kt: int) -> int:
    """Largest bucket routed to the event kernel, taking the leading-True
    prefix of hybrid_route_table (routes must be monotone in occupancy for
    one boundary on the device); -1 when dense always wins."""
    table = hybrid_route_table(op, mt, kt)
    threshold = 0
    while threshold < len(table) and table[threshold]:
        threshold += 1
    return threshold - 1
