"""The tensor-core arithmetic of the pipelined APEC matmuls (TPU rows 18
and 16) in repro_torch, on the CPU.

Kernels 18 and 16 (csrc/apec_matmul_csr_pipe.cu on csrc/tile_tc.cuh)
multiply binary spikes by an exact three-way bf16 split of the fp32
weights, w = hi + mid + lo, on bf16 tensor cores. Their CUDA code runs
only on a card (tests/test_torch_cuda.py); here the split itself
(`spike_matmul.split_bf16x3`) is held to exactness as a property, the
products of binary spikes and the parts to the product of the whole
weights in fp64, and the split-order product (lo, mid, hi, each on the
pipelined plain version's gated operands) to `repro`'s prefetching APEC
kernel in interpret mode, with the same numpy inputs, within
1e-5 * max|ref| + 1e-5, the parity contract.
"""
import re
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, st
from repro.core import spikes as jsp
from repro.kernels import ops as jops
from repro.kernels.spike_matmul import apec_matmul_csr_pallas
from repro_torch.kernels import ops, spike_matmul

torch.set_num_threads(1)

CSRC = Path(spike_matmul.__file__).resolve().parent.parent / "csrc"
# (g, M) as tests/test_torch_apec_pipe.py takes them: M ragged against 128
# where g allows it.
GROUPS = ((1, 300), (2, 300), (16, 304), (128, 1024))
K, N = 200, 70


def _bf16_exact(t):
    return torch.equal(t.to(torch.bfloat16).float(), t)


# ------------------------------------------------------------ the split
@given(st.lists(st.tuples(st.floats(min_value=-100.0, max_value=99.0),
                          st.floats(min_value=1.0, max_value=2.0,
                                    exclude_max=True),
                          st.booleans()), min_size=1, max_size=64))
def test_split_bf16x3_is_exact(draws):
    """For finite w with |w| in [2^-100, 2^100]: hi + mid + lo == w
    exactly (summed in fp32, smallest first, and in fp64), every part is
    a bf16 value, and the parts shrink by at least 2^8 each."""
    w = torch.tensor([(-1.0 if neg else 1.0) * mant * 2.0 ** exp
                      for exp, mant, neg in draws], dtype=torch.float32)
    hi, mid, lo = spike_matmul.split_bf16x3(w)
    assert all(_bf16_exact(p) for p in (hi, mid, lo))
    assert torch.equal((lo + mid) + hi, w)
    assert torch.equal(hi.double() + mid.double() + lo.double(), w.double())
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0 ** -8).all())


def test_split_bf16x3_edges():
    """Zeros, powers of two, bf16 values (mid = lo = 0) and values whose
    rounding to bf16 carries into the next binade."""
    w = torch.tensor([0.0, -0.0, 1.0, -2.0 ** -100, 2.0 ** 100, 1.5,
                      1.0 - 2.0 ** -24, 3.0 - 2.0 ** -22, 2.0 ** -100 * 1.7,
                      -(2.0 ** 99) * 1.999999], dtype=torch.float32)
    hi, mid, lo = spike_matmul.split_bf16x3(w)
    assert torch.equal((lo + mid) + hi, w)
    assert all(_bf16_exact(p) for p in (hi, mid, lo))
    assert torch.equal(hi[:6], w[:6]) and not bool(mid[:6].any())


@pytest.mark.parametrize("m,k,n,p", [(256, 384, 96, 0.3), (130, 1536, 40, 0.1),
                                     (64, 432, 96, 0.9)])
def test_binary_products_of_the_parts_are_exact(m, k, n, p):
    """For binary S, S@hi + S@mid + S@lo equals S@w exactly in fp64: each
    product of a spike and a part is exact, so the split loses nothing
    before the kernel's fp32 accumulation."""
    rng = np.random.default_rng(m + k)
    s = torch.from_numpy((rng.random((m, k)) < p).astype(np.float64))
    w = torch.from_numpy((rng.normal(size=(k, n)) / k ** 0.5)
                         .astype(np.float32))
    parts = spike_matmul.split_bf16x3(w)
    got = sum(s @ part.double() for part in parts)
    assert torch.equal(got, s @ w.double())


# ----------------------------------------------- parity with repro
def _apec_case(seed, g, m, k=K, n=N):
    """Clustered binary spikes (empty 128 x 128 tiles, an all-empty m-tile
    row) where every third group repeats its first member, so the overlap
    holds events."""
    rng = np.random.default_rng(seed)
    tiles = rng.random((-(-m // 128), -(-k // 128))) < 0.6
    tiles[0] = True
    mask = np.kron(tiles, np.ones((128, 128)))[:m, :k]
    s = ((rng.random((m, k)) < 0.3) * mask).astype(np.float32)
    grp = s.reshape(m // g, g, k)
    grp[::3] = grp[::3, :1]
    s[128:256] = 0
    w = (rng.normal(size=(k, n)) / k ** 0.5).astype(np.float32)
    return s, w


@pytest.mark.parametrize("g,m", GROUPS)
def test_split_order_product_matches_repro_pipe_interpret(g, m):
    """The kernels' summation order in plain fp32, ((lo + mid) + hi), each
    part through the pipelined plain version on the union work list,
    against `repro`'s `apec_matmul_csr_pallas(..., pipeline=True,
    interpret=True)` on the same spikes: within the parity contract, as
    is the plain version on the whole weights."""
    s, w = _apec_case(300 + g, g, m)
    jov, jres = jops.apec_decompose(jnp.asarray(s), g)
    # `repro`'s kernel takes whole tiles (its wrapper pads as here).
    mp, kp, n_pad = (-(-x // 128) * 128 for x in (m, K, N))
    jres = jnp.pad(jres, ((0, mp - m), (0, kp - K)))
    jov = jnp.pad(jov, ((0, (mp - m) // g), (0, kp - K)))
    jw = jnp.pad(jnp.asarray(w), ((0, kp - K), (0, n_pad - N)))
    occ_r = jsp.tile_occupancy(jres, 128, 128)
    occ_o = jsp.tile_occupancy(jov, 128 // g, 128)
    jcsr = jsp.occupancy_to_csr(occ_r + occ_o, tiling=(128, 128))
    steps = (jcsr.tile_m_idx, jcsr.tile_k_idx)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = np.asarray(apec_matmul_csr_pallas(
            jres, jov, jw, g, jcsr,
            (occ_r[steps] * jcsr.valid).astype(jnp.int32),
            (occ_o[steps] * jcsr.valid).astype(jnp.int32), interpret=True,
            pipeline=True))[:m, :N]
    ov, res = ops.apec_decompose(torch.from_numpy(s), g)
    work = ops.apec_union_worklist(res, ov, g)
    lo_mid_hi = spike_matmul.split_bf16x3(torch.from_numpy(w))[::-1]
    got = None
    for part in lo_mid_hi:
        out = spike_matmul.apec_matmul_csr_pipe(res, ov, part, g, *work)
        got = out if got is None else got + out
    whole = spike_matmul.apec_matmul_csr_pipe(res, ov, torch.from_numpy(w),
                                              g, *work)
    tol = 1e-5 * np.abs(want).max() + 1e-5
    for out in (got, whole):
        assert out.shape == want.shape
        assert np.abs(out.numpy() - want).max() <= tol
    assert not got[128:256].any()


def test_python_apec_ring_mirrors_the_kernel_source():
    """The plain version walks the APEC kernels' ring: its depth is
    csrc/apec_matmul_csr_pipe.cu's kApecStages, its slices
    csrc/tile_mma.cuh's kSlice; the split has three parts
    (csrc/tile_tc.cuh: kParts), the bound chip_smoke counts."""
    def consts(name):
        return dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                               (CSRC / name).read_text()))
    assert int(consts("apec_matmul_csr_pipe.cu")["kApecStages"]) == \
        spike_matmul.APEC_PIPE_STAGES
    assert int(consts("tile_mma.cuh")["kSlice"]) == spike_matmul.PIPE_SLICE
    assert int(consts("tile_tc.cuh")["kParts"]) == \
        len(spike_matmul.split_bf16x3(torch.ones(1)))
