"""The SDSA kernels (TPU rows 7-8 and 9) in repro_torch, on the CPU.

The kernels (csrc/sdsa.cu `sdsa_or_kernel`, csrc/sdsa_causal.cu
`sdsa_causal_kernel`) run on no CPU. What the tests here hold:

  * the plain versions beside the spike entries, and the registry route
    (`ops.sdsa_or` / `ops.causal_sdsa_or`), equal `repro`'s
    `sdsa_jnp` / `causal_sdsa_jnp` and its `pallas-interpret` route
    exactly, in f32 and bf16, at T = 1, 2 and 4, d = 40, 48 and 64,
    ragged N and the models' head-transposed views;
  * the kernels' layout and scan, emulated thread by thread in numpy
    from the sources' constants: the wrapper's descriptor
    (`sdsa_kernel._describe`, the heads folded into the channel axis,
    the vector or scalar path) and the launch plan drive an emulation of
    each kernel's index arithmetic, whose every output element is
    written once and equals the plain version;
  * rows narrower than a warp's units load and store in token order and
    reach their scanning threads through a shared stage, emulated as a
    (token, unit) exchange;
  * the chunk-and-carry scan (a thread's serial prefix-OR, the token
    lanes' shuffles and warp totals, the decoupled look-back over
    chunks) as a hypothesis property against the plain prefix-OR, for
    any unit block, tokens a thread, block size and look-back window,
    and flags found in any mix of aggregate and inclusive states.

The kernels equal these plain versions bit for bit on a card
(tests/test_torch_cuda.py).
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, st
from repro.core import sdsa as jsdsa
from repro.kernels import dispatch as jdispatch
from repro_torch.kernels import ops, sdsa_kernel

torch.set_num_threads(1)
CSRC = Path(sdsa_kernel.__file__).resolve().parent.parent / "csrc"
WARP = 32


def _consts(*names) -> dict:
    text = "".join((CSRC / n).read_text() for n in names)
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


UNITS_H = _consts("sdsa_units.cuh")
CAUSAL = _consts("sdsa_causal.cu")
OR_FORM = _consts("sdsa.cu")


def test_python_geometry_matches_the_sources():
    assert sdsa_kernel.THREADS == UNITS_H["kThreads"]
    assert sdsa_kernel.MAX_UNIT_BLOCK == UNITS_H["kMaxUnitBlock"]
    assert sdsa_kernel.CAUSAL_TOKENS == CAUSAL["kTok"]
    assert CAUSAL["kWindow"] >= 1 and OR_FORM["kBatch"] >= 1
    assert sdsa_kernel.KIND == {torch.float32: 0, torch.bfloat16: 1,
                                torch.uint32: 2}
    text = (CSRC / "sdsa_units.cuh").read_text()
    assert "kF32 = 0, kBF16 = 1, kWords = 2" in text


def test_stage_slots_are_distinct_and_fit_the_stage():
    """Narrow rows' shared stage (sdsa_causal.cu `stage`): every (token,
    unit) of a chunk takes its own padded slot, x + x / 32, inside the
    array's kThreads * kTok + kThreads * kTok / 32 words."""
    threads, tok = UNITS_H["kThreads"], CAUSAL["kTok"]
    x = np.arange(threads * tok)          # chunk tokens x ub = threads * tok
    slots = x + (x >> 5)
    assert len(set(slots.tolist())) == x.size
    assert slots.max() < threads * tok + threads * tok // 32
    text = (CSRC / "sdsa_causal.cu").read_text()
    assert "stage[kThreads * kTok + kThreads * kTok / 32]" in text
    assert text.count("stage[x + (x >> 5)]") == 4


# ------------------------------------------------------------ inputs
def _spikes(rng, shape, p=0.3):
    return (rng.random(shape) < p).astype(np.float32)


def _heads(a: np.ndarray, dtype) -> torch.Tensor:
    """(..., N, H, dh) numpy -> the models' (..., H, N, dh) view of a
    contiguous tensor (`.transpose(-3, -2)`)."""
    return torch.from_numpy(a).to(dtype).transpose(-3, -2)


def _jax(x: torch.Tensor):
    return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16 if
                       x.dtype == torch.bfloat16 else jnp.float32)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, dtype=np.float32))


DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------- plain versions vs repro
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 3, 64, 2, 48), (1, 2, 37, 3, 40),
                                   (4, 1, 9, 2, 64)])
def test_sdsa_or_matches_repro_exactly(dtype, shape):
    """SpikingFormer's (T, B, H, N, dh) view at dh = 48, a ragged N = 37
    at d = 40, and d = 64, against `sdsa_jnp` and the Pallas kernels in
    interpret mode."""
    rng = np.random.default_rng(sum(shape))
    q, k, v = (_heads(_spikes(rng, shape), dtype) for _ in range(3))
    jq, jk, jv = map(_jax, (q, k, v))
    want = np.asarray(jsdsa.sdsa_jnp(jq, jk, jv), dtype=np.float32)
    with jdispatch.use_backend("pallas-interpret", op="sdsa"):
        np.testing.assert_array_equal(
            np.asarray(jdispatch.sdsa(jq, jk, jv), dtype=np.float32), want)
    for got in (sdsa_kernel.sdsa_or_spikes_plain(q, k, v),
                sdsa_kernel.sdsa_or_spikes(q, k, v), ops.sdsa_or(q, k, v)):
        assert got.dtype == dtype and got.shape == q.shape
        _eq(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 2, 50, 2, 64), (2, 2, 33, 3, 48),
                                   (4, 1, 70, 2, 40), (2, 1, 1, 1, 64)])
def test_causal_sdsa_matches_repro_exactly(dtype, shape):
    """The LM's (T, B, H, N, dh) view at T = 1, 2 and 4, d = 40, 48 and
    64, ragged N, against `causal_sdsa_jnp` and the Pallas causal-status
    kernel in interpret mode. Bits at a low rate, so the prefix-OR still
    turns channels on late in the sequence."""
    rng = np.random.default_rng(sum(shape) + 1)
    q = _heads(_spikes(rng, shape), dtype)
    k, v = (_heads(_spikes(rng, shape, 0.08), dtype) for _ in range(2))
    jq, jk, jv = map(_jax, (q, k, v))
    want = np.asarray(jsdsa.causal_sdsa_jnp(jq, jk, jv), dtype=np.float32)
    with jdispatch.use_backend("pallas-interpret", op="causal_sdsa"):
        np.testing.assert_array_equal(np.asarray(
            jdispatch.causal_sdsa(jq, jk, jv), dtype=np.float32), want)
    for got in (sdsa_kernel.causal_sdsa_spikes_plain(q, k, v),
                sdsa_kernel.causal_sdsa_spikes(q, k, v),
                ops.causal_sdsa_or(q, k, v)):
        assert got.dtype == dtype and got.shape == q.shape
        _eq(got, want)


def test_spike_entries_read_nonzero_as_a_spike():
    """-0 is no spike, any other value (negative, tiny, NaN) is one, as
    `pack_spikes` reads it; the output is ones and zeros."""
    vals = torch.tensor([0.0, -0.0, 1.0, -2.0, 1e-30, float("nan")])
    q = vals.repeat(6, 1)[:, None, :]          # (N=6, 1, d=6): d axis
    k = vals[:, None].repeat(1, 6)[:, None, :]
    v = torch.ones_like(k)
    want = ((q != 0) & (k != 0).any(dim=0, keepdim=True)).float()
    _eq(sdsa_kernel.sdsa_or_spikes(q.transpose(0, 1), k.transpose(0, 1),
                                   v.transpose(0, 1)), want.transpose(0, 1))
    got = sdsa_kernel.causal_sdsa_spikes(q[None], k[None], v[None])[0]
    status = torch.cummax((k != 0).to(torch.uint8), dim=0).values.bool()
    _eq(got, ((q != 0) & status).float())


def test_spike_entries_refuse_mismatched_operands():
    q = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="equal operands"):
        sdsa_kernel.sdsa_or_spikes(q, q, torch.zeros(2, 3, 5))
    with pytest.raises(ValueError, match="at least 3"):
        sdsa_kernel.causal_sdsa_spikes(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="unit-stride channel"):
        x = torch.zeros(2, 4, 3).transpose(1, 2)
        sdsa_kernel._describe((x, x, x, torch.empty_like(x)), False)


# ------------------------------------------------ the descriptor
def test_descriptor_folds_the_heads_into_the_channel_axis():
    """SpikingFormer's (T, B, H, N, dh) view: one leading axis of T*B rows
    and H*dh channels, N rows apart; the LM's: T apart, B rows."""
    q = torch.zeros(4, 32, 64, 8, 48).transpose(2, 3)
    vec, units, lay = sdsa_kernel._describe(
        (q, q, q, torch.empty_like(q)), False)
    assert (vec, units, lay[:6]) == (True, 96, [1, 1, 1, 128, 64, 384])
    assert lay[6:11] == [0, 0, 0, 64 * 384, 384]
    q = torch.zeros(2, 8, 1024, 32, 64, dtype=torch.bfloat16).transpose(2, 3)
    vec, units, lay = sdsa_kernel._describe(
        (q, q, q, torch.empty_like(q)), True)
    assert (vec, units, lay[:6]) == (True, 256, [2, 1, 1, 8, 1024, 2048])
    assert lay[6:11] == [8 * 1024 * 2048, 0, 0, 1024 * 2048, 2048]
    # a view one element into its storage takes the scalar path
    flat = torch.zeros(1 + 2 * 5 * 64)
    x = flat[1:].view(2, 5, 64)
    vec, units, _ = sdsa_kernel._describe((x, x, x, torch.empty_like(x)),
                                          False)
    assert (vec, units) == (False, 64)


def test_plans_at_the_model_shapes():
    """The LM's causal call: 64 units a block, 4 slices of its 256
    vectors, 32 chunks of 32 tokens, 1024 blocks; the 32k word row: 1024
    blocks, not one serial walk a (row, word); SpikingFormer's OR call:
    3 slices of 32 vectors, 8 token groups of 8 tokens."""
    lm = sdsa_kernel.causal_plan(8, 1024, 256)
    assert (lm["ub"], lm["slices"], lm["chunk"], lm["chunks"],
            lm["blocks"]) == (64, 4, 32, 32, 1024)
    long = sdsa_kernel.causal_plan(32, 32768, 2)
    assert (long["ub"], long["chunks"], long["blocks"]) == (2, 32, 1024)
    assert sdsa_kernel.unit_block(96) == 32
    assert sdsa_kernel.or_groups(32, 64) == 8
    for units in (2, 6, 8, 10, 12, 24, 30, 96, 128, 256, 384, 512):
        ub = sdsa_kernel.unit_block(units)
        idle = -(-units // ub) * ub - units
        assert idle * 8 <= -(-units // ub) * ub
    assert sdsa_kernel.look_back_words(8, 4, 1, 64) == 0
    assert sdsa_kernel.look_back_words(8, 4, 32, 64) == \
        8 * 4 * 32 * 64 + 8 * 4 * 64 // 2


# --------------------------------------- kernel emulation, thread by thread
def _flat(x: torch.Tensor) -> np.ndarray:
    """The whole storage of `x` as a flat bool array of its spikes."""
    n = x.untyped_storage().nbytes() // x.element_size()
    return (x.as_strided((n,), (1,), 0) != 0).numpy()


def _row_offsets(lay, rows: np.ndarray, o: int) -> np.ndarray:
    r1, r2, r3 = lay[1:4]
    s = lay[6 + 5 * o:11 + 5 * o]
    r3i, rest = rows % r3, rows // r3
    return (rest // r2) * s[1] + (rest % r2) * s[2] + r3i * s[3]


def _unit_masks(flat, base, c, elems, valid):
    """(threads, ...) masks of the units at element offsets `base` + c:
    bit e where element e is a spike."""
    m = np.zeros(base.shape, dtype=np.int64)
    for e in range(elems):
        idx = np.where(valid, base + c + e, 0)
        m |= np.where(valid, flat[idx], False).astype(np.int64) << e
    return m


def _write_units(out, writes, base, c, elems, bits, valid):
    for e in range(elems):
        idx = (base + c + e)[valid]
        np.add.at(writes, idx, 1)
        out[idx] = (bits[valid] >> e) & 1


def _block_scan(m: np.ndarray, ub: int, threads: int):
    """One block's token lanes as sdsa_causal_kernel scans them. m:
    (threads, tok) masks, thread tid = lane l * ub + unit u. -> (before:
    OR of the earlier lanes' aggregates of the same unit, prefix: the
    thread's serial inclusive OR, total: the chunk's OR of each thread's
    unit)."""
    prefix = np.bitwise_or.accumulate(m, axis=1)
    agg = prefix[:, -1]
    tid = np.arange(threads)
    lane, warp, u, l = tid % WARP, tid // WARP, tid % ub, tid // ub
    lanes = threads // ub
    before = np.zeros_like(agg)
    if lanes == 1:
        return before, prefix, agg.copy()
    if ub < WARP:
        incl = agg.copy()
        d = ub
        while d < WARP:                               # __shfl_up_sync
            incl = incl | np.where(lane >= d, incl[np.maximum(tid - d, 0)],
                                   0)
            d *= 2
        before = np.where(lane >= ub, incl[np.maximum(tid - ub, 0)], 0)
        part = np.zeros((threads // WARP, ub), dtype=agg.dtype)
        last = lane >= WARP - ub                      # each warp's total
        part[warp[last], u[last]] = incl[last]
        for w in range(threads // WARP):
            before = before | np.where(w < warp, part[w, u], 0)
        total = np.bitwise_or.reduce(part, axis=0)[u]
    else:
        part = agg.reshape(lanes, ub)
        for j in range(lanes):
            before = before | np.where(j < l, part[j, u], 0)
        total = np.bitwise_or.reduce(part, axis=0)[u]
    return before, prefix, total


def _look_back(flags: list, chunk: int, window: int) -> int:
    """`look_back` in sdsa_causal.cu: read the flags of chunks chunk - 1,
    chunk - 2, ... `window` at a time, OR their values, stop at the
    nearest inclusive one. flags[j] = (state, value): 1 aggregate, 2
    inclusive (the kernel spins on 0)."""
    carry, j = 0, chunk - 1
    while True:
        w = [flags[j - x] if j - x >= 0 else (2, 0) for x in range(window)]
        for state, value in w:
            assert state in (1, 2)
            carry |= value
            if state == 2:
                return carry
        j -= window


def _restage(vals, src_tok, dst_tok, u):
    """Shared-memory stage of the causal kernel's narrow rows: values that
    thread tid holds for tokens src_tok[tid, i] (of unit u[tid]) come out
    at the threads and slots dst_tok names."""
    stage = {(int(tk), int(uu)): int(x) for tks, uu, xs in
             zip(src_tok, u, vals) for tk, x in zip(tks, xs)}
    return np.array([[stage[(int(tk), int(uu))] for tk in tks]
                     for tks, uu in zip(dst_tok, u)], dtype=vals.dtype)


def _emulate_or(q, k, v) -> torch.Tensor:
    out = torch.empty_like(q)
    vec, units, lay = sdsa_kernel._describe((q, k, v, out), False)
    elems = 16 // q.element_size() if vec else 1
    n = lay[4]
    sn = [lay[10 + 5 * o] for o in range(4)]
    rows = math.prod(lay[1:4])
    ub = sdsa_kernel.unit_block(units)
    groups = sdsa_kernel.or_groups(ub, n)
    threads = sdsa_kernel.THREADS
    per_row = ub * groups
    fq, fk, fv = _flat(q), _flat(k), _flat(v)
    res = np.zeros(out.untyped_storage().nbytes() // out.element_size(),
                   dtype=np.int64)
    writes = np.zeros_like(res)
    slices = -(-units // ub)
    tid = np.arange(threads)
    u, grp, rb = tid % ub, (tid // ub) % groups, tid // per_row
    for b in range(slices * -(-rows // (threads // per_row))):
        row = (b // slices) * (threads // per_row) + rb
        unit = (b % slices) * ub + u
        live = (row < rows) & (unit < units)
        off = [_row_offsets(lay, np.where(live, row, 0), o) +
               x.storage_offset() for o, x in enumerate((q, k, v, out))]
        c = unit * elems
        status = np.zeros(threads, dtype=np.int64)
        for tok in range(n):
            mine = live & (tok % groups == grp)
            status |= _unit_masks(fk, off[1] + tok * sn[1], c, elems, mine) \
                & _unit_masks(fv, off[2] + tok * sn[2], c, elems, mine)
        status = np.bitwise_or.reduce(
            status.reshape(-1, groups, ub), axis=1)[rb, u]
        for tok in range(n):
            mine = live & (tok % groups == grp)
            bits = _unit_masks(fq, off[0] + tok * sn[0], c, elems, mine) \
                & status
            _write_units(res, writes, off[3] + tok * sn[3], c, elems, bits,
                         mine)
    return _as_out(res, writes, out)


def _as_out(res, writes, out):
    flat = torch.from_numpy(res.astype(np.float32)).to(out.dtype)
    got = flat.as_strided(out.shape, out.stride(), out.storage_offset())
    hits = torch.from_numpy(writes).as_strided(out.shape, out.stride(),
                                                out.storage_offset())
    assert bool((hits == 1).all()), "an output element written != once"
    return got


def _emulate_causal(q, k, v, window=None) -> torch.Tensor:
    out = torch.empty_like(q)
    vec, units, lay = sdsa_kernel._describe((q, k, v, out), True)
    return _emulate_causal_layout(q, k, v, out, vec, units, lay, window,
                                  words=False)


def _emulate_causal_layout(q, k, v, out, vec, units, lay, window, words):
    elems = 16 // q.element_size() if vec else 1
    t, n = lay[0], lay[4]
    stt = [lay[6 + 5 * o] for o in range(4)]
    sn = [lay[10 + 5 * o] for o in range(4)]
    rows = math.prod(lay[1:4])
    plan = sdsa_kernel.causal_plan(rows, n, units)
    ub, lanes, chunks, slices = (plan[x] for x in ("ub", "lanes", "chunks",
                                                   "slices"))
    tok = sdsa_kernel.CAUSAL_TOKENS
    threads = sdsa_kernel.THREADS
    window = window or CAUSAL["kWindow"]
    if words:
        kw = k.view(torch.int32)
        nwords = kw.untyped_storage().nbytes() // 4
        fk = kw.as_strided((nwords,), (1,), 0).numpy().astype(np.int64) \
            & 0xFFFFFFFF
    else:
        fq, fk, fv = _flat(q), _flat(k), _flat(v)
    size = out.untyped_storage().nbytes() // out.element_size()
    res = np.zeros(size, dtype=np.int64)
    writes = np.zeros_like(res)
    tid = np.arange(threads)
    u, l = tid % ub, tid // ub
    flags = {}
    for b in range(rows * slices * chunks):
        chunk, col = b % chunks, b // chunks
        unit = (col % slices) * ub + u
        live = unit < units
        off = [_row_offsets(lay, np.full(threads, col // slices), o) +
               x.storage_offset() for o, x in enumerate((q, k, v, out))]
        c = unit * elems
        # Token of each (thread, slot): a thread's own consecutive tokens,
        # or, on staged rows (ub < WARP), the loads' token order, whose
        # masks reach the scanning threads through the shared stage.
        staged = ub < WARP
        own = (chunk * lanes + l)[:, None] * tok + np.arange(tok)
        slot_tok = (chunk * lanes * tok + np.arange(tok)[None, :] * lanes +
                    l[:, None]) if staged else own
        m = np.zeros((threads, tok), dtype=np.int64)
        for i in range(tok):
            nt = slot_tok[:, i]
            ok = live & (nt < n)
            for step in range(1 if words else t):
                if words:
                    idx = np.where(ok, off[1] + nt * sn[1] + c, 0)
                    m[:, i] |= np.where(ok, fk[idx], 0)
                else:
                    m[:, i] |= _unit_masks(
                        fk, off[1] + step * stt[1] + nt * sn[1], c,
                        elems, ok) & _unit_masks(
                        fv, off[2] + step * stt[2] + nt * sn[2], c,
                        elems, ok)
        if staged:
            m = _restage(m, slot_tok, own, u)
        before, prefix, total = _block_scan(m, ub, threads)
        carry = np.zeros(threads, dtype=np.int64)
        for uu in range(ub):
            column = flags.setdefault((col, uu), [])
            got = _look_back(column, chunk, window) if chunk else 0
            column.append((2, got | int(total[uu])))
            carry[u == uu] = got
        status = (carry | before)[:, None] | prefix
        if staged:
            status = _restage(status, own, slot_tok, u)
        for i in range(tok):
            nt = slot_tok[:, i]
            ok = live & (nt < n)
            for step in range(1 if words else t):
                base = off[3] + step * stt[3] + nt * sn[3]
                if words:
                    idx = (base + c)[ok]
                    np.add.at(writes, idx, 1)
                    res[idx] = status[:, i][ok]
                else:
                    bits = _unit_masks(fq, off[0] + step * stt[0] +
                                       nt * sn[0], c, elems, ok) \
                        & status[:, i]
                    _write_units(res, writes, base, c, elems, bits, ok)
    if words:
        res = np.where(res >= 2 ** 31, res - 2 ** 32, res)
        flat = torch.from_numpy(res.astype(np.int32))
        hits = torch.from_numpy(writes).as_strided(
            out.shape, out.stride(), out.storage_offset())
        assert bool((hits == 1).all()), "a status word written != once"
        return flat.as_strided(out.shape, out.stride(),
                               out.storage_offset()).view(torch.uint32)
    return _as_out(res, writes, out)


LAYOUTS = [
    # (shape (T, B, N, H, dh), dtype, offset): the models' views, then the
    # scalar path (a view one element into its storage)
    ((2, 2, 12, 2, 48), torch.float32, 0),
    ((2, 2, 70, 4, 64), torch.bfloat16, 0),
    ((1, 3, 41, 3, 40), torch.float32, 0),
    ((4, 1, 9, 2, 64), torch.bfloat16, 0),
    ((2, 2, 23, 2, 40), torch.bfloat16, 1),
]


def _layout_inputs(shape, dtype, offset, seed, p=(0.3, 0.1, 0.1)):
    rng = np.random.default_rng(seed)
    out = []
    for pi in p:
        flat = torch.zeros(offset + math.prod(shape), dtype=dtype)
        flat[offset:] = torch.from_numpy(
            _spikes(rng, (math.prod(shape),), pi)).to(dtype)
        out.append(flat[offset:].view(shape).transpose(2, 3))
    return out


@pytest.mark.parametrize("shape,dtype,offset", LAYOUTS)
def test_or_kernel_emulation_equals_plain(shape, dtype, offset):
    q, k, v = _layout_inputs(shape, dtype, offset, sum(shape))
    want = sdsa_kernel.sdsa_or_spikes_plain(q, k, v)
    assert torch.equal(_emulate_or(q, k, v), want)


@pytest.mark.parametrize("shape,dtype,offset", LAYOUTS)
def test_causal_kernel_emulation_equals_plain(shape, dtype, offset):
    q, k, v = _layout_inputs(shape, dtype, offset, sum(shape) + 7)
    want = sdsa_kernel.causal_sdsa_spikes_plain(q, k, v)
    assert torch.equal(_emulate_causal(q, k, v), want)


def test_causal_emulation_crosses_chunks_with_narrow_rows():
    """A contiguous (T, B*H, N, d) layout with d = 40 f32 (10 vectors: 2
    units a block, 128 token lanes, chunks of 1024 tokens) over N = 2100,
    so the look-back links three chunks of the shuffle path."""
    rng = np.random.default_rng(11)
    shape = (2, 3, 2100, 40)
    q = torch.from_numpy(_spikes(rng, shape))
    k, v = (torch.from_numpy(_spikes(rng, shape, 0.002)) for _ in range(2))
    out = torch.empty_like(q)
    vec, units, lay = sdsa_kernel._describe((q, k, v, out), True)
    assert sdsa_kernel.causal_plan(3, 2100, units)["chunks"] == 3
    want = sdsa_kernel.causal_sdsa_spikes_plain(q, k, v)
    assert torch.equal(_emulate_causal(q, k, v, window=2), want)


def test_causal_word_entry_emulation_equals_plain():
    """The word entry's launch (kv words as k, status out) at a ragged N
    over three chunks."""
    rng = np.random.default_rng(5)
    kv = torch.from_numpy(rng.integers(0, 2 ** 32, (4, 2100, 2),
                                       dtype=np.uint64) &
                          rng.integers(0, 2 ** 32, (4, 2100, 2),
                                       dtype=np.uint64)
                          & np.uint64(0x01000010)).to(torch.int64) \
        .to(torch.int32).view(torch.uint32)
    out = torch.empty_like(kv)
    ops4 = tuple(x[None] for x in (kv, kv, kv, out))
    vec, units, lay = sdsa_kernel._describe(ops4, True)
    assert not vec and units == 2
    got = _emulate_causal_layout(*ops4, vec, units, lay, None, words=True)
    want = sdsa_kernel.sdsa_causal_status_plain(kv)
    assert torch.equal(got[0].view(torch.int32), want.view(torch.int32))


# ------------------------------------------- the chunk-and-carry property
def _emulate_scan(kv: np.ndarray, ub, tok, threads, window, rng):
    """The causal kernel's scan of (rows, N, units) masks with any unit
    block, tokens a thread, block size and look-back window; the earlier
    chunks' flags are found aggregate or inclusive as `rng` draws (chunk
    0's always inclusive)."""
    rows, n, units = kv.shape
    lanes = threads // ub
    chunk_tokens = lanes * tok
    chunks, slices = -(-n // chunk_tokens), -(-units // ub)
    status = np.zeros_like(kv)
    writes = np.zeros(kv.shape, dtype=np.int64)
    tid = np.arange(threads)
    u, l = tid % ub, tid // ub
    for row in range(rows):
        for sl in range(slices):
            unit = sl * ub + u
            live = unit < units
            aggs, incls = [], []
            for chunk in range(chunks):
                idx = (chunk * lanes + l)[:, None] * tok + np.arange(tok)
                ok = live[:, None] & (idx < n)
                m = np.where(ok, kv[row, np.minimum(idx, n - 1),
                                    np.minimum(unit, units - 1)[:, None]], 0)
                before, prefix, total = _block_scan(m, ub, threads)
                carry = np.zeros(threads, dtype=kv.dtype)
                for uu in range(ub):
                    flags = [(2, incls[j][uu]) if j == 0 or rng.random() < 0.5
                             else (1, aggs[j][uu]) for j in range(chunk)]
                    carry[u == uu] = _look_back(flags, chunk, window) \
                        if chunk else 0
                aggs.append(total[:ub])
                incls.append(carry[:ub] | total[:ub])
                got = (carry | before)[:, None] | prefix
                status[row, idx[ok], np.broadcast_to(unit[:, None],
                                                     idx.shape)[ok]] = got[ok]
                np.add.at(writes, (row, idx[ok], np.broadcast_to(
                    unit[:, None], idx.shape)[ok]), 1)
    assert (writes == 1).all()
    return status


@given(seed=st.integers(0, 2 ** 31 - 1), rows=st.integers(1, 2),
       n=st.integers(1, 300), units=st.integers(1, 70),
       log_ub=st.integers(0, 6), tok=st.integers(1, 8),
       log_threads=st.integers(5, 8), window=st.integers(1, 8))
def test_chunk_and_carry_scan_equals_the_prefix_or(seed, rows, n, units,
                                                   log_ub, tok, log_threads,
                                                   window):
    threads = 1 << log_threads
    ub = min(1 << log_ub, threads)
    rng = np.random.default_rng(seed)
    bits = rng.random((rows, n, units, 8)) < 2.0 / max(n, 1)
    kv = (bits.astype(np.int64) << np.arange(8)).sum(-1)
    want = np.bitwise_or.accumulate(kv, axis=1)
    got = _emulate_scan(kv, ub, tok, threads, window, rng)
    np.testing.assert_array_equal(got, want)


def test_look_back_stops_at_the_nearest_inclusive_flag():
    """Values past the nearest inclusive flag are not read into the
    carry (they are in its inclusive value already)."""
    flags = [(2, 1), (1, 2), (2, 7), (1, 8), (1, 16)]
    assert _look_back(flags, 5, 2) == 7 | 8 | 16
    assert _look_back(flags, 5, 8) == 7 | 8 | 16
    assert _look_back(flags, 2, 1) == 1 | 2
    assert _look_back(flags, 1, 3) == 1
