"""The serial APEC kernels' arithmetic (TPU rows 17 and 15) against the
JAX package, on the CPU.

Kernels 17 (f32 spikes) and 15 (uint32 words) walk the events of their
operands: each nonzero of the residual or the overlap adds its weight row
to its output row, acc = fmaf(v, w[k], acc), in k order, the two sums
apart until the epilogue. Their k-order chain plain versions
(`spike_matmul.apec_matmul_csr_chain_plain` and the packed twin) repeat
that arithmetic; the kernels are held to them bit for bit on a card
(tests/test_torch_cuda.py, chip_smoke phases (i) and (j)). Here, on the
same numpy inputs made from a seed, the chains agree with `repro`'s
serial Pallas kernels (`apec_matmul_csr_pallas` /
`apec_matmul_packed_csr_pallas`, interpret mode) on the port's own union
work list within 1e-5 * max|ref| + 1e-5 (the TPU kernels sum each tile
as one dot); the f32 chain equals the packed chain bit for bit on the
same spikes; and the union work list visits each m-tile row's k-tiles in
ascending order, the order the bit equality rests on. Every group size
the kernels take (1, 2, 4, 16, 128), ragged M, K and N, an all-empty
m-tile row, a carried map and none.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spikes as jsp
from repro.kernels.spike_matmul import (apec_matmul_csr_pallas,
                                        apec_matmul_packed_csr_pallas)
from repro_torch.core.spikes import build_csr, pack_spikes_padded
from repro_torch.kernels import apec_kernel, launch_counts, ops, \
    reset_launch_counts, spike_matmul

torch.set_num_threads(1)

# (g, M): M ragged against 128 wherever g allows it (at g = 128 the
# overlap has one row a tile, so M is whole tiles).
GROUPS = ((1, 300), (2, 300), (4, 260), (16, 304), (128, 512))
K, N = 200, 70                       # both ragged against 128 and 4


def _case(seed, g, m, k=K, n=N):
    """Clustered binary spikes with whole empty 128 x 128 tiles and an
    all-empty m-tile row (128:256), every third group a repeat of its
    first member (so the overlap holds events), and in the first m-tile a
    k-tile where every group repeats its first member (an overlap-only
    step) and one where only first members fire (residual-only, g > 1)."""
    rng = np.random.default_rng(seed)
    tiles = rng.random((-(-m // 128), -(-k // 128))) < 0.6
    tiles[0] = True
    mask = np.kron(tiles, np.ones((128, 128)))[:m, :k]
    s = ((rng.random((m, k)) < 0.3) * mask).astype(np.float32)
    grp = s.reshape(m // g, g, k)
    grp[::3] = grp[::3, :1]
    first = s[:128].reshape(128 // g, g, k)
    first[:, :, :128] = first[:, :1, :128]
    first[:, 1:, 128:256] = 0
    s[128:256] = 0
    w = (rng.normal(size=(k, n)) / k ** 0.5).astype(np.float32)
    return s, w


def _operands(s, g, carried, packed):
    """The port's decomposition (`ops.apec_decompose`, or the packed
    kernel's plain version on words), its union work list, and the chain
    plain version for that form."""
    ts = torch.from_numpy(s)
    occ = ops.padded_occupancy(ts) if carried else None
    if packed:
        ov, res = apec_kernel.apec_decompose_packed(pack_spikes_padded(ts), g)
        chain = spike_matmul.apec_matmul_packed_csr_chain_plain
    else:
        ov, res = ops.apec_decompose(ts, g)
        chain = spike_matmul.apec_matmul_csr_chain_plain
    work = ops.apec_union_worklist(res, ov, g, occ, packed=packed)
    return res, ov, work, chain


def _padded(a, rows, cols):
    out = np.zeros((rows, cols), a.dtype)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _np(t):
    """A torch tensor as numpy; uint32 words keep their bits."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _repro_serial(res, ov, w, g, csr, occ_res, occ_ov, packed):
    """`repro`'s serial APEC Pallas kernel in interpret mode on the port's
    operands and work list, zero-padded to its whole 128 tiles."""
    m, n = res.shape[0], w.shape[1]
    mt, kt, nt = -(-m // 128), -(-w.shape[0] // 128), -(-n // 128)
    kcols = kt * 128 // 32 if packed else kt * 128
    jcsr = jsp.TileCSR(*(jnp.asarray(_np(x)) for x in (
        csr.row_ptr, csr.tile_m_idx, csr.tile_k_idx, csr.occ, csr.valid)),
        tiling=(128, 128), map_shape=csr.map_shape)
    kernel = apec_matmul_packed_csr_pallas if packed else \
        apec_matmul_csr_pallas
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = kernel(jnp.asarray(_padded(_np(res), mt * 128, kcols)),
                     jnp.asarray(_padded(_np(ov), mt * 128 // g, kcols)),
                     jnp.asarray(_padded(w, kt * 128, nt * 128)), g, jcsr,
                     jnp.asarray(_np(occ_res)), jnp.asarray(_np(occ_ov)),
                     interpret=True)
    return np.asarray(out)[:m, :n]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("g,m", GROUPS)
def test_chain_matches_repro_serial_kernel(g, m, carried, packed):
    """The chain plain version against `repro`'s serial kernel on the
    same work list, and against the dense product; the empty m-tile row
    is zeros, and the plain version launches nothing."""
    s, w = _case(g, g, m)
    res, ov, work, chain = _operands(s, g, carried, packed)
    reset_launch_counts()
    got = chain(res, ov, torch.from_numpy(w), g, *work).numpy()
    assert not any(launch_counts().values())
    want = _repro_serial(res, ov, w, g, *work, packed)
    for ref in (want, s @ w):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max() + 1e-5
    assert np.all(got[128:256] == 0)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("g,m", GROUPS)
def test_f32_chain_equals_packed_chain(g, m, carried):
    """The same spikes as f32 and as words, each decomposed and listed by
    its own form: the two chains are equal bit for bit (as kernels 17 and
    15 are), and within the contract of the dense plain version."""
    s, w = _case(50 + g, g, m)
    tw = torch.from_numpy(w)
    outs = []
    for packed in (False, True):
        res, ov, work, chain = _operands(s, g, carried, packed)
        outs.append(chain(res, ov, tw, g, *work))
    assert torch.equal(outs[0], outs[1])
    res, ov, work, _ = _operands(s, g, carried, False)
    dense = spike_matmul.apec_matmul_csr_plain(res, ov, tw, g, *work)
    assert (outs[0] - dense).abs().max().item() <= \
        1e-5 * dense.abs().max().item() + 1e-5


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("g,m", GROUPS)
def test_union_worklist_steps_ascend_in_k(g, m, carried, packed):
    """Within every m-tile row the work list's k-tiles strictly ascend:
    the kernels walk a row's steps in list order, so their sums run in k
    order. Every row has at least one step (a dummy one when empty)."""
    s, _ = _case(100 + g, g, m)
    _, _, (csr, occ_r, occ_o), _ = _operands(s, g, carried, packed)
    row_ptr = csr.row_ptr.tolist()
    kidx = csr.tile_k_idx.tolist()
    assert len(row_ptr) == -(-m // 128) + 1
    for r in range(len(row_ptr) - 1):
        ks = kidx[row_ptr[r]:row_ptr[r + 1]]
        assert ks and all(a < b for a, b in zip(ks, ks[1:]))
    # The empty row's only step is a dummy one: both counts 0.
    step = row_ptr[1]
    assert row_ptr[2] - step == 1 and occ_r[step] == 0 and occ_o[step] == 0


def test_chain_gates_each_operand_on_its_own_counts():
    """A union step whose residual count is 0 adds only the overlap sums,
    and the reverse, even where the gated operand holds spikes: the chain
    gates as the kernels do; a multi-bit operand adds v * w."""
    s = torch.ones(256, 128)
    w = torch.ones(128, 4)
    ov, res = ops.apec_decompose(s, 2)            # all overlap, no residual
    res = res + 1.0                               # a residual that is "live"
    csr = build_csr(torch.ones(2, 1, dtype=torch.int32), 128, 128)
    one, zero = torch.ones(2, dtype=torch.int32), \
        torch.zeros(2, dtype=torch.int32)
    chain = spike_matmul.apec_matmul_csr_chain_plain
    assert torch.all(chain(res, ov, w, 2, csr, zero, one) == 128)
    assert torch.all(chain(res, ov, w, 2, csr, one, zero) == 128)
    assert torch.all(chain(res, ov, w, 2, csr, one, one) == 256)
    assert torch.all(chain(3 * res, ov, w, 2, csr, one, zero) == 384)
