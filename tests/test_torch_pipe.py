"""The pipelined CSR spike matmul (TPU rows 12 and 14) in repro_torch
against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through `repro`'s pipelined
Pallas kernels in interpret mode (`pallas-csr-pipe-interpret`,
`packed-csr-pipe-interpret`, `ops.econv_packed(..., pipeline=True)`) and
the port's `cuda-pipe` / `cuda-packed-pipe` routes, whose wrappers run
their plain versions on CPU tensors: the CPU twin of the kernels' copy
ring (`spike_matmul.ring_schedule`, held to the gate contract by
`check_ring_trace`), then the fp32 product. Outputs agree within
1e-5 * max|ref| + 1e-5, the parity contract. A property test holds the
ring's schedule to the contract on random work lists. A TF32 emulation
records the tensor-core alternative: one TF32 pass misses the contract,
a two-term weight split holds it, yet its sums are not the fp32 k-order
sums that the kernels keep (csrc/tile_mma.cuh). The kernels themselves
are held to their plain versions, and to kernel 11 bit for bit, on a
card in tests/test_torch_cuda.py.
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
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro_torch.core.spikes import build_csr, pack_spikes_padded
from repro_torch.kernels import dispatch, launch_counts, ops, \
    reset_launch_counts, spike_matmul

torch.set_num_threads(1)
CSRC = Path(spike_matmul.__file__).resolve().parent.parent / "csrc"


def _clustered(rng, m, k, tile_p=0.6, p=0.3, tile=128):
    tiles = rng.random((-(-m // tile), -(-k // tile))) < tile_p
    mask = np.kron(tiles, np.ones((tile, tile)))[:m, :k]
    return ((rng.random((m, k)) < p) * mask).astype(np.float32)


def _within_contract(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = 1e-5 * np.abs(want).max() + 1e-5
    assert np.abs(got - want).max() <= tol


def _jax_quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.asarray(fn())


def _twords(a):
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32)) \
        .view(torch.uint32)


def _matmul_case(seed, m=300, k=200, n=96):
    """M ragged (300 = 2 x 128 + 44) with an all-empty m-tile row, K not a
    multiple of 128, N = 96 (stage 1's width)."""
    rng = np.random.default_rng(seed)
    s = _clustered(rng, m, k)
    s[128:256] = 0
    w = (rng.normal(size=(k, n)) / k ** 0.5).astype(np.float32)
    return s, w


# ------------------------------------------------- parity with repro
@pytest.mark.parametrize("packed", [False, True])
def test_spike_matmul_pipe_matches_repro_pipe_interpret(packed):
    s, w = _matmul_case(1)
    k = s.shape[1]
    s3 = s.reshape(2, 150, k)
    if packed:
        words = np.asarray(jsp.pack_spikes_padded(jnp.asarray(s3)))
        jargs, targs = (jnp.asarray(words), jnp.asarray(w)), \
            (_twords(words), torch.from_numpy(w))
        kw, jname, tname = {"packed_k": k}, "packed-csr-pipe-interpret", \
            dispatch.CUDA_PACKED_PIPE
    else:
        jargs, targs = (jnp.asarray(s3), jnp.asarray(w)), \
            (torch.from_numpy(s3), torch.from_numpy(w))
        kw, jname, tname = {}, "pallas-csr-pipe-interpret", dispatch.CUDA_PIPE
    with jdispatch.use_backend(jname, op="spike_matmul"):
        assert jdispatch.resolve_attribution("spike_matmul", *jargs,
                                             **kw) == jname
        want = _jax_quiet(lambda: jdispatch.dispatch("spike_matmul", *jargs,
                                                     **kw))
    with dispatch.use_backend(tname, op="spike_matmul"):
        assert dispatch.resolve_attribution("spike_matmul", *targs,
                                            **kw) == tname
        got = dispatch.dispatch("spike_matmul", *targs, **kw)
    _within_contract(got.numpy(), want)
    _within_contract(got.numpy().reshape(-1, w.shape[1]), s @ w)
    assert np.all(got.numpy().reshape(-1, w.shape[1])[128:256] == 0)


@pytest.mark.parametrize("packed", [False, True])
def test_econv_pipe_matches_repro_pipe_interpret(packed):
    """A 3x3 SAME conv whose patch matrix is (300, 216) x (216, 96): M
    ragged, K (and, packed, the padded K) not a multiple of 128."""
    rng = np.random.default_rng(2)
    s = (rng.random((3, 10, 10, 24)) < 0.25).astype(np.float32)
    s[1] = 0                                       # a run of empty rows
    w = (rng.normal(size=(3, 3, 24, 96)) / 216 ** 0.5).astype(np.float32)
    if packed:
        words = np.asarray(jsp.pack_spikes_padded(jnp.asarray(s)))
        want = _jax_quiet(lambda: jops.econv_packed(
            jnp.asarray(words), jnp.asarray(w), packed_k=24, pipeline=True))
        with dispatch.use_backend(dispatch.CUDA_PACKED_PIPE, op="econv"):
            got = dispatch.dispatch(
                "econv", _twords(words), torch.from_numpy(w), stride=1,
                padding="SAME", packed_k=24)
    else:
        name = "pallas-csr-pipe-interpret"
        with jdispatch.use_backend(name, op="econv"):
            assert jdispatch.resolve_attribution(
                "econv", jnp.asarray(s), jnp.asarray(w)) == name
            want = _jax_quiet(lambda: jdispatch.econv(jnp.asarray(s),
                                                      jnp.asarray(w)))
        with dispatch.use_backend(dispatch.CUDA_PIPE, op="econv"):
            got = dispatch.econv(torch.from_numpy(s), torch.from_numpy(w))
    _within_contract(got.numpy(), want)


@pytest.mark.parametrize("packed", [False, True])
def test_pipe_plain_versions_match_serial_and_count_nothing(packed):
    """On the same work list the pipelined plain versions give the serial
    plain versions' product; plain versions launch nothing."""
    s, w = _matmul_case(3, m=260, k=300, n=40)
    ts, tw = torch.from_numpy(s), torch.from_numpy(w)
    csr = build_csr(ops.padded_occupancy(ts), 128, 128)
    reset_launch_counts()
    if packed:
        p = pack_spikes_padded(ts)
        got = spike_matmul.spike_matmul_packed_csr_pipe(p, tw, csr)
        want = spike_matmul.spike_matmul_packed_csr(p, tw, csr)
    else:
        got = spike_matmul.spike_matmul_csr_pipe(ts, tw, csr)
        want = spike_matmul.spike_matmul_csr(ts, tw, csr)
    assert torch.equal(got, want)
    assert not any(launch_counts().values())


def test_pipeline_flag_selects_the_pipe_kernel(monkeypatch):
    """`pipeline=True` on the ops wrappers reaches the pipe wrappers (as
    `repro`'s flag selects its prefetching kernels), False the serial
    ones."""
    seen = []
    for name in ("spike_matmul_csr", "spike_matmul_csr_pipe",
                 "spike_matmul_packed_csr", "spike_matmul_packed_csr_pipe"):
        orig = getattr(spike_matmul, name)
        monkeypatch.setattr(spike_matmul, name,
                            lambda *a, _n=name, _f=orig: (seen.append(_n),
                                                          _f(*a))[1])
    s, w = _matmul_case(4, m=130, k=64, n=8)
    ts, tw = torch.from_numpy(s), torch.from_numpy(w)
    for pipeline in (False, True):
        ops.spike_matmul_csr(ts, tw, pipeline=pipeline)
        ops.spike_matmul_packed(ts, tw, pipeline=pipeline)
        ops.econv_packed(ts.reshape(2, 5, 13, 64), torch.ones(1, 1, 64, 2),
                         pipeline=pipeline)
    assert seen == ["spike_matmul_csr", "spike_matmul_packed_csr",
                    "spike_matmul_packed_csr", "spike_matmul_csr_pipe",
                    "spike_matmul_packed_csr_pipe",
                    "spike_matmul_packed_csr_pipe"]


# --------------------------------------------------------- the ring
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 3)),
                max_size=12),
       st.integers(1, 512), st.integers(2, 4))
def test_ring_schedule_keeps_the_gate_contract(steps, k, stages):
    """On any work list (counts with zeros, k-tiles past K clamped as
    padding steps are not) and ring depth: no copy for an occ == 0 step,
    each issued copy waited on once and computed once, in issue order,
    never more than stages - 1 in flight, a slot refilled only after its
    slice was computed (`check_ring_trace` raises otherwise)."""
    kt = -(-k // 128)
    occ = [o for o, _ in steps]
    kidx = [t % kt for _, t in steps]
    trace = spike_matmul.ring_schedule(occ, kidx, k, stages)
    computed = spike_matmul.check_ring_trace(trace, occ, kidx, k, stages)
    issued = [e[2] for e in trace if e[0] == "issue"]
    assert computed == issued
    assert all(occ[st_] > 0 for st_, _ in issued)
    assert sum(e[0] == "wait" for e in trace) == len(issued)
    in_flight = 0
    for e in trace:
        in_flight += {"issue": 1, "wait": -1}.get(e[0], 0)
        assert in_flight <= stages - 1


def test_ring_check_refuses_a_broken_schedule():
    occ, kidx, k = [2, 0, 1], [0, 1, 2], 300
    trace = spike_matmul.ring_schedule(occ, kidx, k)
    spike_matmul.check_ring_trace(trace, occ, kidx, k)
    dummy = [("issue", 0, (1, 128))] + trace     # a copy for an occ=0 step
    skipped = trace[:-1]                          # a slice never computed
    early = trace[:]                              # a compute before its wait
    i = next(j for j, e in enumerate(early)
             if e[0] == "wait" and early[j + 1][0] == "compute")
    early[i], early[i + 1] = early[i + 1], early[i]
    for bad in (dummy, skipped, early):
        with pytest.raises(RuntimeError, match="copy ring schedule broken"):
            spike_matmul.check_ring_trace(bad, occ, kidx, k)


def test_python_ring_constants_mirror_the_kernel_header():
    """The plain twin walks the ring the kernel builds: its slice depth
    and stage count are csrc/tile_mma.cuh's."""
    src = (CSRC / "tile_mma.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kSlice"]) == spike_matmul.PIPE_SLICE
    assert int(consts["kStages"]) == spike_matmul.PIPE_STAGES


# --------------------------------------------------------- the split
def _tf32(x):
    """fp32 -> TF32 as `cvt.rna.tf32.f32` rounds: to 10 mantissa bits,
    ties away from zero; the result is an fp32 value."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("k,n,multi_bit", [(432, 96, False),
                                           (384, 1536, False),
                                           (1536, 384, False),
                                           (27, 64, True)])
def test_split_tf32_holds_the_parity_contract(k, n, multi_bit):
    """At stage 1's, fc1's and fc2's widths (and the coded conv's K = 27
    with a multi-bit operand) a single TF32 pass misses 1e-5 * max|ref| +
    1e-5 and a split holds it: w = hi + lo (two MMAs, spikes exact), plus
    alo * hi where the operand is not exact in TF32. Its sums still round
    unlike the fp32 fmaf chain in k order, which the kernels and cuBLAS
    compute, on a share of the outputs."""
    rng = np.random.default_rng(k + n)
    s = (rng.random((256, k)) < 0.2).astype(np.float32)
    if multi_bit:
        s *= (rng.integers(-128, 128, size=s.shape) * (0.87 / 127)
              ).astype(np.float32)
    w = (rng.normal(size=(k, n)) / k ** 0.5).astype(np.float32)
    ref = s.astype(np.float64) @ w.astype(np.float64)
    tol = 1e-5 * np.abs(ref).max() + 1e-5
    hi = _tf32(w)
    lo = _tf32(w - hi)
    ahi = _tf32(s)
    alo = _tf32(s - ahi)
    assert np.array_equal(ahi, s) != multi_bit      # binary spikes: exact
    one_pass = ahi.astype(np.float64) @ hi.astype(np.float64)
    split = ahi.astype(np.float64) @ (hi.astype(np.float64) + lo) + \
        alo.astype(np.float64) @ hi.astype(np.float64)
    assert np.abs(one_pass - ref).max() > tol
    assert np.abs(split - ref).max() <= tol / 20
    chain = np.zeros((32, n), dtype=np.float32)
    for kk in range(k):                          # fmaf(s, w, acc), k order
        chain = (chain.astype(np.float64) + s[:32, kk:kk + 1].astype(
            np.float64) * w[kk].astype(np.float64)).astype(np.float32)
    assert np.mean(split[:32].astype(np.float32) != chain) > 0.01


# ------------------------------------------------------ the registry
def test_pipe_routes_rank_as_the_reference():
    """`cuda-pipe` / `cuda-packed-pipe` rank above `cuda` / `cuda-packed`
    as `repro`'s pallas-csr-pipe (26) / packed-csr-pipe (31) above
    pallas-csr (25) / packed-csr (30), degrade along cuda-packed-pipe ->
    cuda-packed -> cuda -> cuda-pred and cuda-pipe -> cuda, and are kernel
    routes (a degrade on the card may walk through them)."""
    for op in ("spike_matmul", "econv"):
        pipe = dispatch.get_backend(op, dispatch.CUDA_PIPE)
        ppipe = dispatch.get_backend(op, dispatch.CUDA_PACKED_PIPE)
        cuda = dispatch.get_backend(op, dispatch.CUDA)
        packed = dispatch.get_backend(op, dispatch.CUDA_PACKED)
        jpipe = jdispatch.get_backend(op, "pallas-csr-pipe")
        jcsr = jdispatch.get_backend(op, "pallas-csr")
        jppipe = jdispatch.get_backend(op, "packed-csr-pipe")
        jpacked = jdispatch.get_backend(op, "packed-csr")
        assert (pipe.priority, cuda.priority) == (26, 20)
        assert (ppipe.priority, packed.priority) == (31, 30)
        assert jpipe.priority > jcsr.priority and pipe.priority > cuda.priority
        assert jppipe.priority > jpacked.priority and \
            ppipe.priority > packed.priority
        assert (pipe.fallback, ppipe.fallback) == (dispatch.CUDA,
                                                   dispatch.CUDA_PACKED)
        assert (packed.fallback, cuda.fallback) == (dispatch.CUDA,
                                                    dispatch.CUDA_PRED)
        assert pipe.platforms == ppipe.platforms == ("cuda",)
        assert ppipe.payload == ("packed",) and pipe.payload == ("dense",)
        assert pipe.differentiable and ppipe.differentiable
    assert {dispatch.CUDA_PIPE, dispatch.CUDA_PACKED_PIPE} <= \
        set(dispatch.KERNEL_ROUTES)


def test_card_walk_degrades_through_the_serial_kernels(monkeypatch):
    """With the platform read as `cuda`, a refused pipe call degrades to
    the serial kernel of its payload, never to a plain route."""
    import dataclasses
    monkeypatch.setattr(dispatch, "_platform", lambda args: "cuda")
    spec = dispatch._REGISTRY["spike_matmul"]
    for name in (dispatch.CUDA_PIPE, dispatch.CUDA_PACKED_PIPE):
        monkeypatch.setitem(spec.backends, name, dataclasses.replace(
            spec.backends[name], supports=lambda *a, **k: "refused here"))
    args, kwargs = dispatch.example_inputs("spike_matmul", "cpu")
    pargs, pkwargs = dispatch._packed_example("spike_matmul",
                                              torch.device("cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert dispatch.resolve_attribution("spike_matmul", *args,
                                            **kwargs) == "cuda<-cuda-pipe"
        assert dispatch.resolve_attribution(
            "spike_matmul", *pargs, **pkwargs) == \
            "cuda-packed<-cuda-packed-pipe"
