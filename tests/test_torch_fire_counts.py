"""The LIF fire with counts, dense and packed (TPU rows 4, 5 and 6), in
repro_torch, on the CPU.

The kernel (csrc/lif.cu `lif_counts_kernel`) runs on no CPU. What the
tests here hold is its layout, read from the source's constants and
emulated thread by thread in numpy: a thread owns one 4-lane vector of
one row; every live (row, lane) belongs to exactly one thread; a word
group (8 threads, or a narrow row's threads) lies in one row and one
warp and takes its lanes in bit order, and its shuffle rounds give
`pack_spikes_padded`'s words; the warp sums and shared-memory sums (R % 8
== 0) or the per-cell warp sums added into a zeroed map (ragged R, where
chunks span steps) give `chunk_counts`; and no model width idles more
than a quarter of the threads. The plain versions, which the kernels
equal bit for bit on a card (tests/test_torch_cuda.py), are held here to
`repro`'s `ops.lif_occ` in interpret mode, dense and packed, at the
narrow widths the layout packs.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, st
from repro.core.spikes import pack_spikes_padded as jpack_padded
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro_torch.core.spikes import pack_spikes_padded
from repro_torch.kernels import lif_scan

torch.set_num_threads(1)
SOURCE = (Path(lif_scan.__file__).resolve().parent.parent / "csrc" /
          "lif.cu").read_text()
WARP = 32
# The widths the models fire at: SegNet 8 and 16, SpikingFormer-4-384's
# stages 48 / 96 / 192 and 384, the CNNs' 64 and up, the FFN's 1536.
MODEL_K = (8, 16, 48, 64, 96, 128, 192, 256, 384, 512, 1536)
LAYOUT_K = (6, 8, 16, 48, 64, 96, 192, 1536)
LAYOUT_R = (12, 2048)


def _consts() -> dict:
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE)}


def _layout(k: int) -> dict:
    """`counts_layout` evaluated from lif.cu's constants."""
    c = _consts()
    tile_vecs, v = c["kLanes"] // 4, -(-k // 4)
    if v >= tile_vecs:
        slots = tile_vecs
    elif v >= c["kWordVecs"]:
        slots = -(-v // c["kWordVecs"]) * c["kWordVecs"]
    else:
        slots = 1
        while slots < v:
            slots *= 2
    chunks = max(1, c["kCountThreads"] // (c["kChunk"] * slots))
    return {"slots": slots, "chunks": chunks,
            "threads": c["kChunk"] * chunks * slots,
            "kt": -(-k // c["kLanes"])}


def _threads(rows: int, k: int) -> dict:
    """Per (item, thread) of the launch: the row and first lane it owns
    and whether it is live, as `lif_counts_kernel` computes them."""
    lay = _layout(k)
    chunk = _consts()["kChunk"]
    block_rows = chunk * lay["chunks"]
    items = -(-rows // block_rows) * lay["kt"]
    item = np.arange(items)[:, None]
    tid = np.arange(lay["threads"])[None, :]
    tile = item % lay["kt"]
    slot = tid % lay["slots"]
    row = item // lay["kt"] * block_rows + tid // lay["slots"]
    vidx = tile * (_consts()["kLanes"] // 4) + slot
    n0 = 4 * vidx
    row, n0, vidx = np.broadcast_arrays(row, n0, vidx)
    slot = np.broadcast_to(slot, row.shape)
    tid = np.broadcast_to(tid, row.shape)
    return dict(lay=lay, row=row, n0=n0, vidx=vidx, slot=slot, tid=tid,
                tile=np.broadcast_to(tile, row.shape),
                live=(row < rows) & (n0 < k))


def _nibbles(th: dict, s: np.ndarray) -> np.ndarray:
    """(T, items, threads) 4-bit spike nibbles: bit i is lane n0 + i of
    the thread's row (0 past K and for dead threads)."""
    t_steps, rows, k = s.shape
    nib = np.zeros((t_steps,) + th["row"].shape, dtype=np.int64)
    r = np.minimum(th["row"], rows - 1)
    for i in range(4):
        lane = th["n0"] + i
        ok = th["live"] & (lane < k)
        bit = s[:, r, np.minimum(lane, k - 1)] != 0
        nib |= (bit & ok).astype(np.int64) << i
    return nib


def _popcount(x: np.ndarray) -> np.ndarray:
    return sum((x >> i) & 1 for i in range(4))


def _spikes(rng, t_steps, rows, k, p=0.3):
    return (rng.random((t_steps, rows, k)) < p).astype(np.float32)


# ------------------------------------------------------------- the layout
@pytest.mark.parametrize("k", LAYOUT_K + (37, 130))
def test_layout_mirrors_lif_cu(k):
    """lif_scan's layout and constants are csrc/lif.cu's; a block is whole
    warps of at most kCountThreads threads holding whole 8-row chunks."""
    c = _consts()
    assert (c["kChunk"], c["kLanes"], c["kWordVecs"], c["kCountThreads"]) \
        == (lif_scan.CHUNK, lif_scan.LANES, lif_scan.WORD_VECS,
            lif_scan.COUNT_THREADS)
    lay = _layout(k)
    assert lif_scan.counts_layout(k) == lay
    assert lay["threads"] % WARP == 0 and lay["threads"] <= c["kCountThreads"]
    assert WARP % min(lay["slots"], c["kWordVecs"]) == 0
    body = SOURCE[SOURCE.index("inline CountsLayout counts_layout("):]
    body = body[:body.index("\n}\n")]
    for line in ("slots = kTileVecs;",
                 "slots = (int)((v + kWordVecs - 1) / kWordVecs * kWordVecs);",
                 "while (slots < v) slots *= 2;",
                 "const int fit = kCountThreads / (kChunk * slots);"):
        assert line in body


@pytest.mark.parametrize("rows", LAYOUT_R)
@pytest.mark.parametrize("k", LAYOUT_K)
def test_every_live_lane_belongs_to_one_thread(k, rows):
    th = _threads(rows, k)
    seen = np.zeros((rows, k), dtype=int)
    for i in range(4):
        lane = th["n0"] + i
        ok = th["live"] & (lane < k)
        np.add.at(seen, (th["row"][ok], lane[ok]), 1)
    assert (seen == 1).all()
    # a live thread holds at least one lane; dead ones hold none
    assert (th["n0"][th["live"]] < k).all()


@pytest.mark.parametrize("rows", LAYOUT_R)
@pytest.mark.parametrize("k", LAYOUT_K)
def test_word_groups_lie_in_one_row_and_take_lanes_in_bit_order(k, rows):
    """The wg threads of a word group (8, or a narrow row's slots) start
    at a multiple of wg, lie in one warp and one row, and thread j of the
    group holds bits 4j .. 4j + 3 of word vidx / 8; each (row, word) of
    the output is stored by exactly one group's first thread."""
    th = _threads(rows, k)
    wg = min(th["lay"]["slots"], _consts()["kWordVecs"])
    kw = -(-k // 32)
    tid, row, vidx = th["tid"], th["row"], th["vidx"]
    start = tid - th["slot"] % wg
    assert (start % wg == 0).all()
    assert (start // WARP == (start + wg - 1) // WARP).all()
    first = np.take_along_axis(row, start, axis=1)
    assert (row == first).all()
    word = vidx // _consts()["kWordVecs"]
    assert (np.take_along_axis(word, start, axis=1) == word).all()
    assert (th["n0"] - 32 * word == 4 * (th["slot"] % wg)).all()
    leader = (th["slot"] % wg == 0) & (row < rows) & (word < kw)
    stored = np.zeros((rows, kw), dtype=int)
    np.add.at(stored, (row[leader], word[leader]), 1)
    assert (stored == 1).all()


def _kernel_counts(rows, k, s):
    """The count map the kernel writes: warp-segment sums into shared
    memory and one sum a (step, chunk) where R % 8 == 0; else the sums of
    a warp's lanes that share a cell, added into a zeroed map."""
    th = _threads(rows, k)
    lay, chunk = th["lay"], _consts()["kChunk"]
    t_steps = s.shape[0]
    c = _popcount(_nibbles(th, s))                  # (T, items, threads)
    out = np.zeros((-(-t_steps * rows // chunk), lay["kt"]), dtype=np.int64)
    items, threads = th["row"].shape
    if rows % chunk == 0:
        seg = min(WARP, chunk * lay["slots"])
        segs = chunk * lay["slots"] // seg
        part = c.reshape(t_steps, items, threads // seg, seg).sum(-1)
        written = np.zeros_like(out)
        for ch in range(lay["chunks"]):
            first = th["row"][:, ch * chunk * lay["slots"]]
            assert (th["row"][:, ch * chunk * lay["slots"]:
                              (ch + 1) * chunk * lay["slots"]] // chunk ==
                    first[:, None] // chunk).all()
            for t in range(t_steps):
                total = part[t, :, ch * segs:(ch + 1) * segs].sum(-1)
                ok = first < rows
                cell = ((t * rows + first[ok]) // chunk, th["tile"][ok, 0])
                out[cell] = total[ok]
                np.add.at(written, cell, 1)
        assert (written == 1).all()
    else:
        for t in range(t_steps):
            cell = np.where(th["row"] < rows,
                            (t * rows + th["row"]) // chunk * lay["kt"] +
                            th["tile"], -1)
            for w in range(threads // WARP):
                lanes = slice(w * WARP, (w + 1) * WARP)
                for item in range(items):
                    ids, sums = cell[item, lanes], c[t, item, lanes]
                    for cid in np.unique(ids[ids >= 0]):
                        out.reshape(-1)[cid] += sums[ids == cid].sum()
    return out


@pytest.mark.parametrize("rows", LAYOUT_R)
@pytest.mark.parametrize("k", LAYOUT_K)
def test_each_count_cell_sums_its_rows_and_lanes(k, rows):
    """Against `chunk_counts` on random spikes, chunks that span steps at
    R = 12 included."""
    s = _spikes(np.random.default_rng(k + rows), 2, rows, k)
    want = lif_scan.chunk_counts(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(_kernel_counts(rows, k, s), want)


@pytest.mark.parametrize("k", MODEL_K)
def test_no_model_width_idles_a_quarter_of_the_threads(k):
    """At R = 2048 rows (a multiple of every block's rows) at most 25% of
    the launched threads own no live lane; the old block of 128 lanes
    idled 94% at K = 8."""
    th = _threads(2048, k)
    assert 1 - th["live"].mean() <= 0.25
    lay = _layout(k)
    live = sum(min(lay["slots"], max(0, -(-(k - 128 * j) // 4)))
               for j in range(lay["kt"]))
    assert abs((1 - live / (lay["kt"] * lay["slots"])) -
               (1 - th["live"].mean())) < 1e-12


# ------------------------------------------------------ the word assembly
def _shuffle_words(rows, k, s):
    """The packed mode's words: each thread's nibble shifted to bits
    4 (slot % wg), OR-ed over xor-shuffle rounds 1, 2, 4 (below wg) across
    its warp's 32 lanes, stored by the group's first thread."""
    th = _threads(rows, k)
    wg = min(th["lay"]["slots"], _consts()["kWordVecs"])
    kw = -(-k // 32)
    nib = _nibbles(th, s)
    t_steps = s.shape[0]
    items, threads = th["row"].shape
    w = nib << (4 * (th["slot"] % wg))
    w = w.reshape(t_steps, items, threads // WARP, WARP)
    lane = np.arange(WARP)
    o = 1
    while o < wg:
        w = w | w[..., lane ^ o]
        o <<= 1
    w = w.reshape(t_steps, items, threads)
    word = th["vidx"] // _consts()["kWordVecs"]
    leader = (th["slot"] % wg == 0) & (th["row"] < rows) & (word < kw)
    out = np.zeros((t_steps, rows, kw), dtype=np.int64)
    for t in range(t_steps):
        out[t, th["row"][leader], word[leader]] = w[t][leader]
    return out.astype(np.uint32)


@given(st.integers(1, 3), st.integers(1, 40), st.integers(1, 300),
       st.floats(0.0, 1.0), st.integers(0, 2 ** 31))
def test_shuffled_words_are_the_packed_spikes(t_steps, rows, k, p, seed):
    s = _spikes(np.random.default_rng(seed), t_steps, rows, k, p)
    want = pack_spikes_padded(torch.from_numpy(s)).view(torch.int32)
    got = torch.from_numpy(_shuffle_words(rows, k, s).view(np.int32))
    assert torch.equal(got, want)


def test_shuffled_words_at_the_model_widths():
    rng = np.random.default_rng(11)
    for k in LAYOUT_K:
        s = _spikes(rng, 2, 12, k)
        want = pack_spikes_padded(torch.from_numpy(s)).view(torch.int32)
        assert torch.equal(torch.from_numpy(
            _shuffle_words(12, k, s).view(np.int32)), want), k


# --------------------------------------- the plain versions against repro
def _drive(rng, shape):
    x = (rng.normal(size=shape) * 0.9 + 0.4).astype(np.float32)
    x.reshape(-1)[:4] = [1.0, 0.5, 0.25, 2.0]      # threshold ties at 0.5
    return x


def _words(t):
    """uint32 words as int32 (a torch tensor or a numpy array)."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int32).numpy()
    return np.asarray(t).view(np.int32)


@pytest.mark.parametrize("k", [8, 16, 48, 64, 96])
def test_plain_fires_match_jax_lif_occ_at_aligned_rows(k):
    """R = 16: `lif_counts_plain`, `lif_counts_packed_plain` and
    `lif_counts_fwd_plain` against `repro`'s `ops.lif_occ` (the Pallas
    kernels in interpret mode): spikes, words and the chunk counts, with
    the 128-row tile map from the port's `ops.lif_occ`."""
    from repro_torch.kernels import ops
    x = _drive(np.random.default_rng(k), (4, 2, 8, k))
    js, jocc, jchunks = jops.lif_occ(jnp.asarray(x), v_th=0.5)
    jw, _, jchunks_p = jops.lif_occ(jnp.asarray(x), v_th=0.5, packed=True)
    xt = torch.from_numpy(x.reshape(4, 16, k))
    s, cnt = lif_scan.lif_counts_plain(xt, v_th=0.5)
    w, cnt_p = lif_scan.lif_counts_packed_plain(xt, v_th=0.5)
    s_f, cnt_f, _ = lif_scan.lif_counts_fwd_plain(xt, v_th=0.5)
    np.testing.assert_array_equal(s.numpy().reshape(x.shape), np.asarray(js))
    np.testing.assert_array_equal(s_f.numpy(), s.numpy())
    np.testing.assert_array_equal(_words(w).reshape(jw.shape), _words(jw))
    want = np.asarray(jchunks)[:cnt.shape[0]]
    assert not np.asarray(jchunks)[cnt.shape[0]:].any()
    for c in (cnt, cnt_p, cnt_f):
        np.testing.assert_array_equal(c.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jchunks_p), np.asarray(jchunks))
    _, occ, _ = ops.lif_occ(torch.from_numpy(x), v_th=0.5)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


@pytest.mark.parametrize("k", [8, 16, 48, 64, 96])
def test_plain_fires_match_jax_at_ragged_rows(k):
    """R = 12 (chunks span steps; `repro` gates its kernel off and its
    registry runs `ref`): spikes, words and both maps."""
    from repro_torch.kernels import ops
    x = _drive(np.random.default_rng(100 + k), (4, 3, 4, k))
    want = jdispatch.get_backend("lif_scan_occ", "ref").fn(
        jnp.asarray(x), v_th=0.5)
    xt = torch.from_numpy(x.reshape(4, 12, k))
    s, cnt = lif_scan.lif_counts_plain(xt, v_th=0.5)
    w, cnt_p = lif_scan.lif_counts_packed_plain(xt, v_th=0.5)
    np.testing.assert_array_equal(s.numpy().reshape(x.shape),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(
        _words(w), _words(jpack_padded(jnp.asarray(want[0]).reshape(
            4, 12, k))))
    chunks = np.asarray(want[2])
    for c in (cnt, cnt_p):
        np.testing.assert_array_equal(c.numpy(), chunks[:c.shape[0]])
    assert not chunks[cnt.shape[0]:].any()
    got = ops.lif_occ(torch.from_numpy(x), v_th=0.5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
