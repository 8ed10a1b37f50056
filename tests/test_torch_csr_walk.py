"""The serial CSR kernels' arithmetic (TPU rows 11 and 13) against the
JAX package, on the CPU.

Kernels 11 (f32 spikes, any value) and 13 (uint32 words) walk the events
of their work list's live steps: each nonzero spike adds its weight row to
its output row, acc = fmaf(v, w[k], acc), in k order. Their k-order chain
plain versions (`spike_matmul.spike_matmul_csr_chain_plain` and the packed
twin) repeat that arithmetic, with an exact fmaf; the kernels are held to
them bit for bit on a card (tests/test_torch_cuda.py, chip_smoke phases (b)
and (j)). Here, on the same numpy inputs made from a seed, the chains agree
with `repro`'s serial Pallas kernels (`spike_matmul_csr_pallas` /
`spike_matmul_packed_csr_pallas`, interpret mode) on the port's own work
list within 1e-5 * max|ref| + 1e-5 (the TPU kernels sum each tile as one
dot); the f32 chain equals the packed chain bit for bit on binary spikes;
the chain equals the APEC chain with an all-zero overlap bit for bit (the
walk the two kernel pairs share, csrc/event_walk.cuh); and the work list
visits each m-tile row's k-tiles in ascending order, the order the bit
equality rests on. Ragged M, K and N, an all-empty m-tile row, dummy
steps, multi-bit f32 spikes, a carried map and none.
"""
import warnings
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spikes as jsp
from repro.kernels.spike_matmul import (spike_matmul_csr_pallas,
                                        spike_matmul_packed_csr_pallas)
from repro_torch.core.events import EventTensor
from repro_torch.core.spikes import (build_csr, pack_spikes_padded,
                                     ragged_packed_tile_occupancy)
from repro_torch.kernels import launch_counts, ops, reset_launch_counts, \
    spike_matmul

torch.set_num_threads(1)

# (M, K, N): ragged against 128 in each, and N against 4.
SHAPES = ((300, 200, 70), (260, 384, 33), (384, 130, 96))
FORMS = ("f32", "multibit", "packed")


def _case(seed, m, k, n, multibit=False):
    """Clustered binary spikes with whole empty 128 x 128 tiles and an
    all-empty m-tile row (128:256); `multibit` scales each spike by a
    signed value in [-1, 1) (a coded drive's values)."""
    rng = np.random.default_rng(seed)
    tiles = rng.random((-(-m // 128), -(-k // 128))) < 0.6
    tiles[0] = True
    mask = np.kron(tiles, np.ones((128, 128)))[:m, :k]
    s = ((rng.random((m, k)) < 0.3) * mask).astype(np.float32)
    if multibit:
        s *= rng.integers(-128, 128, size=s.shape).astype(np.float32) / 127
    s[128:256] = 0
    w = (rng.normal(size=(k, n)) / k ** 0.5).astype(np.float32)
    return s, w


def _operands(s, form, carried):
    """The spike operand in `form` (f32 or words), the port's work list for
    it (from the map an `EventTensor` carries, or the operand's own), and
    the chain plain version for that form."""
    ts = torch.from_numpy(s)
    packed = form == "packed"
    a = pack_spikes_padded(ts) if packed else ts
    if carried:
        csr = EventTensor.from_spikes(ts, pack=packed).csr(128, 128)
    elif packed:
        csr = build_csr(ragged_packed_tile_occupancy(a, 128, 128), 128, 128)
    else:
        csr = build_csr(ops.padded_occupancy(ts), 128, 128)
    chain = spike_matmul.spike_matmul_packed_csr_chain_plain if packed else \
        spike_matmul.spike_matmul_csr_chain_plain
    return a, csr, chain


def _padded(a, rows, cols):
    out = np.zeros((rows, cols), a.dtype)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _np(t):
    """A torch tensor as numpy; uint32 words keep their bits."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _repro_serial(a, w, csr, packed):
    """`repro`'s serial CSR Pallas kernel in interpret mode on the port's
    operand and work list, zero-padded to its whole 128 tiles."""
    m, n = a.shape[0], w.shape[1]
    mt, kt, nt = -(-m // 128), -(-w.shape[0] // 128), -(-n // 128)
    kcols = kt * 128 // 32 if packed else kt * 128
    jcsr = jsp.TileCSR(*(jnp.asarray(_np(x)) for x in (
        csr.row_ptr, csr.tile_m_idx, csr.tile_k_idx, csr.occ, csr.valid)),
        tiling=(128, 128), map_shape=csr.map_shape)
    kernel = spike_matmul_packed_csr_pallas if packed else \
        spike_matmul_csr_pallas
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = kernel(jnp.asarray(_padded(_np(a), mt * 128, kcols)),
                     jnp.asarray(_padded(w, kt * 128, nt * 128)), jcsr,
                     interpret=True)
    return np.asarray(out)[:m, :n]


def _close(got, ref):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max() + 1e-5


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_chain_matches_repro_serial_kernel(m, k, n, form, carried):
    """The chain plain version against `repro`'s serial kernel on the same
    work list, and against the dense product; the empty m-tile row is
    zeros, and the plain version launches nothing."""
    s, w = _case(m + k, m, k, n, multibit=form == "multibit")
    a, csr, chain = _operands(s, form, carried)
    reset_launch_counts()
    got = chain(a, torch.from_numpy(w), csr).numpy()
    assert not any(launch_counts().values())
    _close(got, _repro_serial(a, w, csr, form == "packed"))
    _close(got, s @ w)
    assert np.all(got[128:256] == 0)


@pytest.mark.parametrize("packed", [False, True])
def test_chain_skips_dummy_steps(packed):
    """A step whose count is 0 adds nothing, though its tile holds spikes,
    in the chain as in `repro`'s kernel; the other steps of its row still
    add theirs."""
    m, k, n = 300, 384, 40
    s, w = _case(7, m, k, n)
    s[:128, :128] = 1.0               # a full tile the list will drop
    a, csr, chain = _operands(s, "packed" if packed else "f32", False)
    assert csr.tile_k_idx[0] == 0 and csr.occ[0] > 0
    occ = csr.occ.clone()
    occ[0] = 0
    dummy = csr._replace(occ=occ)
    got = chain(a, torch.from_numpy(w), dummy).numpy()
    _close(got, _repro_serial(a, w, dummy, packed))
    kept = s.copy()
    kept[:128, :128] = 0
    _close(got, kept @ w)
    assert np.array_equal(got[128:], chain(a, torch.from_numpy(w),
                                           csr).numpy()[128:])


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_f32_chain_equals_packed_chain(m, k, n, carried):
    """The same binary spikes as f32 and as words, each listed by its own
    form: the two chains are equal bit for bit (as kernels 11 and 13 are),
    and within the contract of the dense plain version."""
    s, w = _case(50 + m, m, k, n)
    tw = torch.from_numpy(w)
    outs = []
    for form in ("f32", "packed"):
        a, csr, chain = _operands(s, form, carried)
        outs.append(chain(a, tw, csr))
    assert torch.equal(outs[0], outs[1])
    a, csr, _ = _operands(s, "f32", carried)
    dense = spike_matmul.spike_matmul_csr_plain(a, tw, csr)
    assert (outs[0] - dense).abs().max().item() <= \
        1e-5 * dense.abs().max().item() + 1e-5


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_chain_equals_apec_chain_without_overlap(m, k, n, form):
    """The CSR chain is the APEC chain with an all-zero overlap operand
    whose counts are 0 on every step, bit for bit: the template identity
    kernels 11 / 13 and 17 / 15 share (csrc/event_walk.cuh)."""
    s, w = _case(100 + m, m, k, n, multibit=form == "multibit")
    a, csr, chain = _operands(s, form, False)
    tw = torch.from_numpy(w)
    g = 2
    ov = torch.zeros((m // g, a.shape[1]), dtype=a.dtype)
    none = torch.zeros_like(csr.occ)
    apec = spike_matmul.apec_matmul_packed_csr_chain_plain \
        if form == "packed" else spike_matmul.apec_matmul_csr_chain_plain
    assert torch.equal(chain(a, tw, csr),
                       apec(a, ov, tw, g, csr, csr.occ, none))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_worklist_steps_ascend_in_k(m, k, n, packed, carried):
    """Within every m-tile row the work list's k-tiles strictly ascend:
    the kernels walk a row's steps in list order, so their sums run in k
    order. Every row has at least one step, the empty row's a dummy one
    (count 0)."""
    s, _ = _case(200 + m, m, k, n)
    _, csr, _ = _operands(s, "packed" if packed else "f32", carried)
    row_ptr = csr.row_ptr.tolist()
    kidx = csr.tile_k_idx.tolist()
    assert len(row_ptr) == -(-m // 128) + 1
    for r in range(len(row_ptr) - 1):
        ks = kidx[row_ptr[r]:row_ptr[r + 1]]
        assert ks and all(a < b for a, b in zip(ks, ks[1:]))
    step = row_ptr[1]
    assert row_ptr[2] - step == 1 and csr.occ[step] == 0


def _round_f32(x: Fraction) -> float:
    """x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - x),
                                     int(np.float32(y).view(np.int32)) & 1))


def test_fmaf_rounds_once():
    """`_fmaf`, the chain's multi-bit step, against fmaf taken exactly
    (rational arithmetic, one rounding to float32), on coded-drive values
    times weights of wide range, with cancelling addends and addends half
    an ulp of the product away (the cases a product rounded first gets
    wrong)."""
    rng = np.random.default_rng(3)
    n = 3000
    a = (rng.integers(-128, 128, n) / 127).astype(np.float32)
    b = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 20, n)
         ).astype(np.float32)
    c = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 20, n)
         ).astype(np.float32)
    prod = a.astype(np.float64) * b
    c[:1000] = -prod[:1000].astype(np.float32)
    c[1000:2000] = (prod[1000:2000] * 2.0 ** -24).astype(np.float32)
    got = spike_matmul._fmaf(*(torch.from_numpy(x) for x in (a, b, c)))
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) +
                                Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal((a * b + c).astype(np.float32), want)
