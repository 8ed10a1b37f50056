"""The pipelined CSR matmul's f32 thread tile (TPU row 12) and the
streaming LIF fire's lanes (TPU row 1, f32 and bf16) in repro_torch, on
the CPU.

Kernel 12 (csrc/spike_matmul_csr_pipe.cu `csr_pipe_kernel` on f32
spikes, csrc/tile_mma.cuh `ThreadTile`, `fma_tile_slice`, `store_tile`)
runs on no CPU. What the tests here hold is its layout, read from the
source: each output of a 128 x BN block belongs to one thread, whose
fmaf chain takes the slice's k-columns once each in k order (the chain
that keeps it bit for bit with kernels 11, 13 and 14, checked on a card
in tests/test_torch_cuda.py), and a warp's shared-memory reads of spike
pieces and weight runs need no more wavefronts than their distinct
words. The fire (csrc/lif.cu `lif_kernel`) takes 16-byte vectors only
where every row of its operands starts 16-byte aligned; the property
here is that rule, and its plain version (the CPU path of
`lif_scan.lif`) equals `repro`'s `lif_scan_pallas` in interpret mode on
bf16 drives whose P is not a multiple of 8, the kernel's scalar tail.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, st
from repro.core.lif import LIFConfig as JLIF, lif_scan as jlif_scan
from repro.kernels.lif_scan import lif_scan_pallas
from repro_torch.kernels import lif_scan, spike_matmul

torch.set_num_threads(1)
CSRC = Path(spike_matmul.__file__).resolve().parent.parent / "csrc"
TILE = spike_matmul.TILE
THREADS = 256
WARP = 32
BANKS = 32


def _header_consts(name: str) -> dict:
    src = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def _thread_tile(bn: int) -> dict:
    """ThreadTile<BN>'s constants, evaluated from csrc/tile_mma.cuh's
    table (rows, columns), and the k-columns `fma_tile_slice` reads from
    a row at once."""
    src = (CSRC / "tile_mma.cuh").read_text()
    body = src[src.index("struct ThreadTile {"):]
    body = body[:body.index("};")]
    rm = re.search(r"kRM = BN == 128 \? (\d+) : BN == 32 \? (\d+) : (\d+);",
                   body)
    cn = re.search(r"kCN = BN == 96 \? (\d+) : (\d+);", body)
    kv = re.search(r"for \(int c0 = 0; c0 < kSlice; c0 \+= (\d+)\)",
                   _fma_tile_slice_source())
    assert rm and cn and kv, "ThreadTile's table moved: update _thread_tile"
    rm = int(rm.group(1) if bn == 128 else rm.group(2) if bn == 32
             else rm.group(3))
    cn = int(cn.group(1) if bn == 96 else cn.group(2))
    return {"rm": rm, "cn": cn, "g": bn // cn, "rg": TILE // rm,
            "runs": cn // 4, "kv": int(kv.group(1))}


def _fma_tile_slice_source() -> str:
    src = (CSRC / "tile_mma.cuh").read_text()
    body = src[src.index("void fma_tile_slice("):]
    return body[:body.index("\n}\n")]


def _fma_tile_slice_trace(bn: int, slice_k: int):
    """Per thread, the (row, column, k) of every fmaf `fma_tile_slice`
    runs, in its order: pieces of 4 k-columns; per column the rows i and
    runs q of the thread's tile."""
    t = _thread_tile(bn)
    for tid in range(THREADS):
        cg, rg = tid % t["g"], tid // t["g"]
        ops = []
        for c0 in range(0, slice_k, t["kv"]):
            for u in range(t["kv"]):
                for i in range(t["rm"]):
                    for q in range(t["runs"]):
                        c = 4 * cg + 4 * t["g"] * q
                        ops += [(rg + t["rg"] * i, c + x, c0 + u)
                                for x in range(4)]
        yield tid, ops


def test_kernel_12_takes_the_shared_thread_tile():
    """Kernel 12's f32 path and kernel 14's word path run one kernel
    template on one thread tile and one store, and the f32 product reads
    the spike stage in 16-byte pieces of 4 k-columns."""
    src = (CSRC / "spike_matmul_csr_pipe.cu").read_text()
    assert "fma_tile_slice<BN>(a_stage, b_stage, acc);" in src
    assert "add_word_slice<BN>(a_stage, b_stage, acc);" in src
    assert src.count("__global__") == 1
    assert "store_tile<BN>(out, m0, n0, m, n, acc);" in src
    hdr = (CSRC / "tile_mma.cuh").read_text()
    body = _fma_tile_slice_source()
    assert "using T = ThreadTile<BN>;" in body
    assert "float4 av[T::kRM];" in body
    assert "fma4(s, wv[q], acc[i][q]);" in body
    for gone in ("fma_slice(", "store_acc(", "int pick_bn(", "WordTile"):
        assert gone not in hdr and gone not in src


@pytest.mark.parametrize("bn", [128, 96, 64, 32])
def test_f32_thread_tile_covers_each_output_once(bn):
    """Every output of a 128 x BN block belongs to exactly one thread,
    and that thread's fmaf chain for it takes each k-column of the slice
    once, in k order: one fmaf a product, as kernel 11's chain."""
    owner = -np.ones((TILE, bn), dtype=int)
    slice_k = spike_matmul.PIPE_SLICE
    for tid, ops in _fma_tile_slice_trace(bn, slice_k):
        chains: dict = {}
        for r, c, k in ops:
            chains.setdefault((r, c), []).append(k)
        for (r, c), ks in chains.items():
            assert owner[r, c] == -1, f"({r}, {c}) held twice"
            owner[r, c] = tid
            assert ks == list(range(slice_k)), f"({r}, {c}) chain {ks}"
    assert (owner >= 0).all()


def _wavefronts(word_addrs) -> tuple:
    """(wavefronts a warp's shared-memory access takes, the least it
    could take): the most distinct 4-byte words any bank serves, and the
    distinct words over 32 banks."""
    words = set(word_addrs)
    per_bank: dict = {}
    for w in words:
        per_bank.setdefault(w % BANKS, set()).add(w)
    return max(len(v) for v in per_bank.values()), -(-len(words) // BANKS)


@pytest.mark.parametrize("bn", [128, 96, 64, 32])
def test_f32_thread_tile_reads_are_conflict_free(bn):
    """With the stage rows' pads (spikes kSlice + kPadA floats, weights
    BN + kPadB), every spike-piece read (a warp's consecutive rows at one
    piece: a broadcast over its column groups) and every weight-run read
    (G consecutive 16-byte chunks) of a warp takes as few wavefronts as
    its distinct words allow, and each read is aligned to its width."""
    t = _thread_tile(bn)
    consts = _header_consts("tile_mma.cuh")
    row_a = spike_matmul.PIPE_SLICE + consts["kPadA"]
    row_b = bn + consts["kPadB"]
    assert (row_a * 4) % 16 == 0 and (row_b * 4) % 16 == 0
    for warp in range(THREADS // WARP):
        lanes = range(WARP * warp, WARP * (warp + 1))
        for c0 in range(0, spike_matmul.PIPE_SLICE, t["kv"]):
            for i in range(t["rm"]):
                addrs = []
                for tid in lanes:
                    base = (tid // t["g"] + t["rg"] * i) * row_a + c0
                    assert base % t["kv"] == 0
                    addrs += range(base, base + t["kv"])
                got, least = _wavefronts(addrs)
                assert got == least, (bn, warp, c0, i)
            for q in range(t["runs"]):
                addrs = []
                for tid in lanes:
                    base = c0 * row_b + 4 * (tid % t["g"]) + 4 * t["g"] * q
                    assert base % 4 == 0
                    addrs += range(base, base + 4)
                got, least = _wavefronts(addrs)
                assert got == least, (bn, warp, c0, q)


def test_python_ring_constants_mirror_tile_mma():
    """The CPU twins and the tile tests use csrc/tile_mma.cuh's slice
    depth, ring depth and work-list tile, and kernel 12's spike stage
    rows stay a multiple of 16 bytes (its LDS.128 pieces)."""
    consts = _header_consts("tile_mma.cuh")
    assert consts["kSlice"] == spike_matmul.PIPE_SLICE
    assert consts["kStages"] == spike_matmul.PIPE_STAGES
    assert consts["kThreads"] == THREADS
    assert _header_consts("tile_fma.cuh")["kTile"] == TILE
    assert ((consts["kSlice"] + consts["kPadA"]) * 4) % 16 == 0


# ------------------------------------------------------------- the fire
def _vec_rule(t: int, p: int, width: int, *offsets) -> bool:
    """csrc/lif.cu's `launch_lif` rule for 16-byte vectors: every operand
    16-byte aligned (byte offsets here) and P a multiple of the lanes a
    vector holds (or a single step)."""
    lanes = 16 // width
    return (p % lanes == 0 or t == 1) and all(o % 16 == 0 for o in offsets)


@given(st.integers(1, 6), st.integers(1, 300), st.sampled_from([2, 4]),
       st.lists(st.integers(0, 7), min_size=2, max_size=3))
def test_fire_vectors_are_aligned_wherever_the_rule_takes_them(
        t, p, width, elems):
    """Where the rule takes 16-byte vectors, every vector a thread loads
    or stores (neurons V j .. V j + V - 1 of step t, whole vectors only;
    the ragged tail goes scalar) starts 16-byte aligned in every operand;
    every neuron of every step is handled once, by a vector or by the
    scalar path."""
    lanes = 16 // width
    offsets = [e * width for e in elems]
    vec = _vec_rule(t, p, width, *offsets)
    seen = np.zeros((t, p), dtype=int)
    for j in range(-(-p // lanes)):
        n0 = j * lanes
        whole = vec and n0 + lanes <= p
        for step in range(t):
            if whole:
                for off in offsets:
                    assert (off + (step * p + n0) * width) % 16 == 0
            seen[step, n0:min(n0 + lanes, p)] += 1
    assert (seen == 1).all()


def test_fire_kernel_keeps_the_rule_and_one_rounding_an_op():
    """The rule above is the source's, and the streaming kernel keeps the
    plain version's step: each operation rounded on its own."""
    src = (CSRC / "lif.cu").read_text()
    assert ("(p % V == 0 || t_steps == 1) && aligned16(x) &&\n"
            "                     aligned16(s) && (!kResidual || "
            "aligned16(vres))") in src
    step = src[src.index("float lif_step("):]
    step = step[:step.index("\n}\n")]
    assert "__fadd_rn(__fmul_rn(v, decay), x)" in step
    assert "__fsub_rn(vv, __fmul_rn(s, v_th))" in step
    assert "__fmul_rn(vv, __fsub_rn(1.0f, s))" in step


def _bf16_drive(rng, t, p):
    x = rng.normal(0.6, 0.8, (t, p)).astype(np.float32)
    x[0, :6] = [1.0, 0.5, 2.0, 0.99609375, 1.0078125, 0]
    return jnp.asarray(x).astype(jnp.bfloat16)


@pytest.mark.parametrize("p", [1003, 13, 8 * 129 + 5])
def test_bf16_fire_at_ragged_p_matches_the_jax_kernel(p):
    """At T = 2 and P % 8 != 0 (the streaming kernel's scalar path) the
    bf16 fire's plain version equals `repro`'s `lif_scan_pallas` in
    interpret mode (one (1, P) block) on the same bf16 drive, threshold
    ties included, spikes in bf16."""
    rng = np.random.default_rng(p)
    jx = _bf16_drive(rng, 2, p)
    want = np.asarray(lif_scan_pallas(jx[:, None, :], block_m=1, block_n=p,
                                      interpret=True)[:, 0, :]
                      .astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    got = lif_scan.lif(tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("t,p,soft", [(4, 1003, True), (1, 13, False),
                                      (5, 4 * 33 + 2, True)])
def test_f32_fire_at_ragged_p_matches_the_jax_reference(t, p, soft):
    """The f32 fire and its residual mode at P % 4 != 0 against `repro`'s
    `core.lif.lif_scan` on the same drive: spikes equal, and the residual
    mode's spikes equal the primal's."""
    rng = np.random.default_rng(t * p)
    x = rng.normal(0.4, 0.9, (t, p)).astype(np.float32)
    x[0, :4] = [1.0, 0.5, 2.0, 0.25]
    want = np.asarray(jlif_scan(jnp.asarray(x), JLIF(
        decay=0.5, v_th=1.0, soft_reset=soft)))
    tx = torch.from_numpy(x)
    got = lif_scan.lif(tx, soft_reset=soft)
    np.testing.assert_array_equal(got.numpy(), want)
    s, vres = lif_scan.lif_fwd(tx, soft_reset=soft)
    assert torch.equal(s, got) and vres.shape == tx.shape
