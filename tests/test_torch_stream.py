"""The predicated spike matmul's copy ring (TPU row 10) and the pipelined
word kernel's launch (TPU row 14) in repro_torch, on the CPU.

Kernel 10 (csrc/spike_matmul.cu) streams each m-tile row's live k-tiles
through a ring of its own: step j of the row is k-tile j, gated by the
map, in the CSR kernels' slices and depth. `pred_ring_columns` here is
the CPU twin of that ring (`spike_matmul.ring_schedule` over the map
row, held to the gate contract by `check_ring_trace`), so the properties
here are the kernel's schedule: k-tiles in order, no copy for a dead
tile, waits only on committed groups, zeros for an empty row, and the
columns it computes are exactly those the plain version's map gate
keeps. The product is held to `repro`'s `spike_matmul_pallas` in
interpret mode in tests/test_torch_cnn.py, and the kernel to kernel 12
bit for bit on a card in tests/test_torch_cuda.py.

Kernels 12 and 14 (csrc/tile_mma.cuh: ThreadTile, fma_tile_slice,
add_word_slice) cover each block's outputs once with their thread
tiles, and pick their n-tile width (`tile_mma::pick_bn_waves`) for the
blocks an SM their launch bounds give; the picks themselves are read
from the C library on a card in tests/test_torch_cuda.py, and kernel
12's f32 reads are checked in tests/test_torch_tile.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hypothesis_compat import given, st
from repro_torch.core.spikes import TileCSR
from repro_torch.kernels import spike_matmul

torch.set_num_threads(1)
CSRC = Path(spike_matmul.__file__).resolve().parent.parent / "csrc"
TILE = spike_matmul.TILE


def _pred_trace(row, k):
    kidx = list(range(len(row)))
    return spike_matmul.ring_schedule(row, kidx, k), kidx


def pred_ring_columns(occ: torch.Tensor, k: int) -> torch.Tensor:
    """(MT, K) bool: the columns of each m-tile row that kernel 10's ring
    computes. Its steps are the map row's k-tiles in order (step j is
    k-tile j, gated by occ[row, j] > 0): the CSR kernels' ring twin on a
    work list of every (row, k-tile) of the map."""
    mt, kt = occ.shape
    steps = torch.arange(mt * kt, dtype=torch.int32)
    csr = TileCSR(row_ptr=torch.arange(0, mt * kt + 1, kt, dtype=torch.int32),
                  tile_m_idx=steps // kt, tile_k_idx=steps % kt,
                  occ=occ.reshape(-1).to(torch.int32),
                  valid=torch.ones(mt * kt, dtype=torch.int32))
    return spike_matmul._ring_columns(csr, k)[0]


@given(st.lists(st.integers(0, 3), min_size=1, max_size=6),
       st.integers(0, 127))
def test_pred_ring_walks_the_live_k_tiles_in_order(row, short):
    """On any map row and K ending anywhere in the last k-tile: every
    PIPE_SLICE-deep slice before K of each live k-tile is issued once, in
    k order; a dead k-tile issues nothing; each wait allows in flight only
    groups committed after its slice (at most PIPE_STAGES - 2); every
    issued slice is computed once, after its wait."""
    k = len(row) * TILE - short
    stages = spike_matmul.PIPE_STAGES
    trace, kidx = _pred_trace(row, k)
    computed = spike_matmul.check_ring_trace(trace, row, kidx, k, stages)
    issued = [e[2] for e in trace if e[0] == "issue"]
    assert computed == issued
    k0s = [k0 for _, k0 in issued]
    assert k0s == sorted(k0s) and len(set(k0s)) == len(k0s)
    assert all(row[st_] > 0 for st_, _ in issued)
    assert k0s == [j * TILE + kk for j, o in enumerate(row) if o > 0
                   for kk in range(0, TILE, spike_matmul.PIPE_SLICE)
                   if j * TILE + kk < k]
    in_flight = 0
    for e in trace:
        in_flight += {"issue": 1, "wait": -1}.get(e[0], 0)
        assert 0 <= in_flight <= stages - 1
        if e[0] == "wait":
            assert e[2] <= stages - 2


def test_pred_ring_refuses_a_broken_schedule():
    """The contract check catches a copy of a dead k-tile, k-tiles out of
    order, a wait that lets an uncommitted group count as landed, and a
    slice never computed."""
    row, k = [2, 0, 1], 300
    trace, kidx = _pred_trace(row, k)
    spike_matmul.check_ring_trace(trace, row, kidx, k)
    dead = [("issue", 0, (1, 128))] + trace
    issues = [i for i, e in enumerate(trace) if e[0] == "issue"]
    swapped = trace[:]
    a, b = issues[0], issues[1]
    swapped[a], swapped[b] = ("issue", trace[a][1], trace[b][2]), \
        ("issue", trace[b][1], trace[a][2])
    w = next(i for i, e in enumerate(trace) if e[0] == "wait" and e[2] > 0)
    loose = trace[:w] + [("wait", trace[w][1], trace[w][2] + 1)] + \
        trace[w + 1:]
    for bad in (dead, swapped, loose, trace[:-1]):
        with pytest.raises(RuntimeError, match="copy ring schedule broken"):
            spike_matmul.check_ring_trace(bad, row, kidx, k)


def test_pred_ring_issues_nothing_for_an_empty_row_which_writes_zeros():
    row, k = [0, 0, 0], 300
    trace, _ = _pred_trace(row, k)
    assert trace == []
    occ = torch.tensor([[1, 0, 2], [0, 0, 0], [0, 3, 0]], dtype=torch.int32)
    cols = pred_ring_columns(occ, k)
    assert not cols[1].any()
    assert cols[0, :128].all() and not cols[0, 128:256].any()
    assert cols[0, 256:].all() and cols[2, 128:256].all()
    s = torch.ones(300, k)
    out = spike_matmul.spike_matmul_pred(s, torch.ones(k, 3), occ)
    assert torch.all(out[128:256] == 0)
    assert torch.all(out[:128] == 128 + 44) and torch.all(out[256:] == 128)


@pytest.mark.parametrize("m,k,n,multi_bit", [(300, 200, 16, False),
                                           (260, 288, 16, False),
                                           (600, 144, 2, False),
                                           (300, 27, 16, True)])
def test_pred_plain_sums_exactly_the_gated_tiles(m, k, n, multi_bit):
    """The ring twin computes exactly the live tiles' columns before K:
    the spikes it keeps give the plain version's map-gated product bit
    for bit."""
    rng = np.random.default_rng(m + k + n)
    s = (rng.random((m, k)) < 0.3).astype(np.float32)
    if multi_bit:
        s *= rng.integers(-128, 128, size=s.shape).astype(np.float32) / 127
    w = rng.normal(size=(k, n)).astype(np.float32)
    mt, kt = -(-m // TILE), -(-k // TILE)
    occ = torch.from_numpy(rng.integers(0, 3, size=(mt, kt)).astype(np.int32))
    occ[-1] = 0
    ts, tw = torch.from_numpy(s), torch.from_numpy(w)
    cols = pred_ring_columns(occ, k).repeat_interleave(TILE, 0)[:m]
    got = torch.matmul(ts * cols, tw)
    want = spike_matmul.spike_matmul_pred_plain(ts, tw, occ)
    assert torch.equal(got, want)
    assert torch.all(got[(mt - 1) * TILE:] == 0)


def test_pred_ring_is_the_csr_kernels_ring():
    """The twin walks the ring the kernel builds: csrc/spike_matmul.cu
    takes its slice depth and stage count from csrc/tile_mma.cuh, whose
    values the twin mirrors (tests/test_torch_pipe.py checks them)."""
    src = (CSRC / "spike_matmul.cu").read_text()
    assert "using tile_mma::kSlice;" in src
    assert "using tile_mma::kStages;" in src
    assert "tile_mma::RowCursor<tile_mma::OneGate, tile_mma::TileIndex>" \
        in src


# ------------------------------------------- kernel 10's TMA form (N > 16)
def _wide_run(rows, k, blocks, choose=None):
    """Per block, the twin's programs over the tiles it walks (block b:
    tiles b, b + blocks, ...) and their checked run."""
    out = []
    for b in range(blocks):
        mine = rows[b::blocks]
        prog = spike_matmul.tma_ring_programs(mine, k)
        out.append((mine, prog, spike_matmul.run_tma_ring(
            *prog, choose=choose)))
    return out


@given(st.lists(st.lists(st.integers(0, 2), min_size=3, max_size=3),
                min_size=1, max_size=7),
       st.integers(0, 127), st.integers(1, 3),
       st.lists(st.integers(0, 2), min_size=1, max_size=64))
def test_tma_ring_computes_each_live_slice_once_in_order(rows, short,
                                                         blocks, picks):
    """On any map rows shared out over persistent blocks and any
    interleaving of producer, consumers and box landings: the producer
    issues exactly the live k-tiles' PIPE_SLICE-deep slices before K, in
    k order, tile after tile (a dead k-tile issues no copy); every wait
    passes on exactly the phase it means (never on a stage no copy was
    issued to, never a lap ahead); no box lands in a stage still being
    read; each tile's consumers compute its live slices in k order; a
    tile with none stores its zeros."""
    k = 3 * TILE - short
    it = iter(picks * 64)

    def choose(n):
        return next(it, 0) % n
    for mine, (producer, _), done in _wide_run(rows, k, blocks, choose):
        want = [[k0 for _, k0 in spike_matmul._map_slices(r, k)]
                for r in mine]
        assert [op[2][1] for op in producer if op[0] == "issue"] == \
            [k0 for ks in want for k0 in ks]
        assert sorted(done) == list(range(len(mine)))
        assert [done[t] for t in range(len(mine))] == want


def _broken(producer, consumers, how):
    """(producer, consumers, `empty`'s arrival count) of a broken ring."""
    if how == "no_empty_wait":          # refills without asking
        return [op for op in producer if op[:2] != ("wait", "empty")], \
            consumers, None
    if how == "stale_parity":           # waits on the previous lap's phase
        return producer, [[(op[0], op[1], op[2], 1 - op[3], op[4])
                           if op[0] == "wait" else op for op in c]
                          for c in consumers], None
    if how == "early_arrive":           # frees the stage before computing
        out = []
        for op in consumers[0]:
            if op[0] == "compute":
                out.append(("arrive", op[1]))
                out.append(op)
            elif op[0] != "arrive":
                out.append(op)
        return producer, [out] + consumers[1:], None
    if how == "one_arrival":            # `empty` armed for one warp only
        return producer, consumers, 1
    if how == "dead_copy":              # a dead k-tile's slice issued
        slot = producer[0][1]
        return [("issue", slot, (0, TILE))] + producer, consumers, None
    raise ValueError(how)


@pytest.mark.parametrize("how", ["no_empty_wait", "stale_parity",
                                 "early_arrive", "one_arrival", "dead_copy"])
def test_tma_ring_refuses_a_broken_schedule(how):
    """The twin catches a producer that refills a stage without waiting
    for its consumers, consumers that wait on the wrong parity, a warp
    that frees a stage before reading it, an `empty` barrier that
    completes on one warp's arrival while the others still read, and a
    copy of a dead k-tile."""
    rows, k = [[2, 0, 1], [1, 1, 1], [0, 0, 0], [3, 0, 2]], 300
    producer, consumers = spike_matmul.tma_ring_programs(rows, k)
    spike_matmul.run_tma_ring(producer, consumers)
    *bad, arrivals = _broken(producer, consumers, how)
    for choose in (None, lambda n: n - 1, lambda n: n // 2,
                   lambda n: 1 % n):
        try:
            spike_matmul.run_tma_ring(*bad, choose=choose, arrivals=arrivals)
        except RuntimeError as err:
            assert "TMA ring schedule broken" in str(err)
            break
    else:
        pytest.fail(f"{how} went unnoticed")


def test_tma_ring_writes_zeros_for_an_empty_row_and_gates_the_plain_product():
    """An all-empty map row issues nothing and stores its tile; the
    columns the twin computes over persistent blocks are exactly those the
    plain version's map gate keeps, so its product is the plain one bit
    for bit."""
    rows, k = [[0, 0, 0]], 300
    producer, consumers = spike_matmul.tma_ring_programs(rows, k)
    assert producer == [] and consumers == [[("store", 0)]] * 2
    assert spike_matmul.run_tma_ring(producer, consumers) == {0: []}
    rng = np.random.default_rng(7)
    m, n = 700, 40
    s = (rng.random((m, k)) < 0.3).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    occ = torch.from_numpy(rng.integers(0, 3, size=(6, 3)).astype(np.int32))
    occ[2] = 0
    ts, tw = torch.from_numpy(s), torch.from_numpy(w)
    for blocks in (1, 4):
        cols = spike_matmul.tma_ring_columns(occ, k, blocks)
        assert torch.equal(cols, pred_ring_columns(occ, k))
        got = torch.matmul(ts * cols.repeat_interleave(TILE, 0)[:m], tw)
        assert torch.equal(got, spike_matmul.spike_matmul_pred_plain(
            ts, tw, occ))
        assert torch.all(got[2 * TILE:3 * TILE] == 0)


def test_tma_ring_twin_mirrors_the_kernel():
    """The twin's ring depth is csrc/spike_matmul.cu's kWideStages; the
    kernel walks each map row with the cursor the rings share, waits on
    `empty` for the previous fill and on `full` for the current one with
    the twin's parities, arms `empty` for one arrival a consumer warp
    (each warp arrives once, after its reads) and `full` with the stage's
    whole bytes (TMA counts a box's zero-filled elements too)."""
    src = (CSRC / "spike_matmul.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kWideStages"]) == spike_matmul.WIDE_STAGES
    body = src[src.index("pred_tma_kernel(const"):]
    body = body[:body.index("\n}\n")]
    for line in ("bar_init(&full[i], 1);",
                 "bar_init(&empty[i], kConsumers / 32);",
                 "if (threadIdx.x % 32 == 0) bar_arrive(&empty[slot]);",
                 "if (fill > 0) bar_wait(&empty[slot], (fill - 1) & 1);",
                 "bar_expect(&full[slot], W::kStageBytes);",
                 "bar_wait(&full[slot], (slice / kWideStages) & 1);",
                 "map_row(occ, mt, kt, k); cur.valid();"):
        assert line in body, line
    assert "using MapCursor = tile_mma::RowCursor<tile_mma::OneGate, " \
        "tile_mma::TileIndex>;" in src
    assert "constexpr int kWideThreads = kConsumers + 32;" in src


# ------------------------------------------ kernels 12 and 14's launch
# ThreadTile's (rows, columns) a thread holds per n-tile width
# (csrc/tile_mma.cuh; checked against the source below).
WORD_TILES = {128: (8, 8), 96: (4, 12), 64: (4, 8), 32: (2, 8)}


@pytest.mark.parametrize("source,kernel,picker", [
    ("spike_matmul_csr_pipe.cu", "csr_pipe_kernel",
     r"pick_bn_waves\(n, mt, kBlocksPerSM\)"),
    ("apec_matmul_csr_pipe.cu", "apec_pipe_kernel",
     r"pick_bn_waves\(n, mt, 1, kMaxBN\)"),
])
def test_wave_picker_counts_the_blocks_an_sm_the_kernel_declares(
        source, kernel, picker):
    """Kernels 12 / 14 (one template, f32 spikes or words) and 18 / 16
    share one n-tile picker; each asks it for whole waves of as many
    blocks an SM as its __launch_bounds__ give."""
    src = (CSRC / source).read_text()
    bounds = re.search(r"__launch_bounds__\(kThreads, (\w+)\)\s*"
                       + kernel + r"\(", src)
    assert bounds, f"{kernel}'s launch bounds moved"
    per_sm = bounds.group(1)
    if per_sm == "kBlocksPerSM":
        per_sm = re.search(r"constexpr int kBlocksPerSM = (\d+);",
                           src).group(1)
    assert per_sm == ("2" if kernel == "csr_pipe_kernel" else "1")
    assert re.search(picker, src)
    assert "inline int pick_bn(" not in src
    assert "cudaDeviceGetAttribute" not in src


@pytest.mark.parametrize("bn", sorted(WORD_TILES))
def test_word_thread_tiles_cover_each_output_once(bn):
    """ThreadTile's layout (thread t: column group t % G, row group t // G;
    rows rg + RG i, columns 4 cg + 4 G q + 0..3) covers the block's
    128 x BN outputs exactly once with 256 threads, each holding at least
    8 columns in runs of 4."""
    rm, cn = WORD_TILES[bn]
    g, rgs = bn // cn, TILE // rm
    assert g * rgs == 256 and cn % 4 == 0 and cn >= 8
    seen = np.zeros((TILE, bn), dtype=int)
    for t in range(256):
        cg, rg = t % g, t // g
        for i in range(rm):
            for q in range(cn // 4):
                c = 4 * cg + 4 * g * q
                seen[rg + rgs * i, c:c + 4] += 1
    assert (seen == 1).all()
    src = (CSRC / "tile_mma.cuh").read_text()
    table = re.search(r"kRM = (BN == 128 \? 8 : BN == 32 \? 2 : 4);"
                      r"\s*static constexpr int kCN = (BN == 96 \? 12 : 8);",
                      src)
    assert table, "ThreadTile's table moved: update WORD_TILES"
    assert rm == (8 if bn == 128 else 2 if bn == 32 else 4)
    assert cn == (12 if bn == 96 else 8)
