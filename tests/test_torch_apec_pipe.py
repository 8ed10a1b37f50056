"""The pipelined fused APEC matmul (TPU rows 18 and 16) in repro_torch
against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through `repro`'s prefetching
APEC kernels in interpret mode (`ops.apec_matmul_csr(..., pipeline=True)`
and `ops.apec_matmul_packed(..., pipeline=True)`) and the port's
`cuda-pipe` / `cuda-packed-pipe` routes, whose wrappers run their plain
versions on CPU tensors: the union-gated CPU twin of the kernels' copy
ring (`spike_matmul.ring_schedule(..., occ_ov=)`, held to the gate
contract by `check_ring_trace`), then the fp32 product. Outputs agree
within 1e-5 * max|ref| + 1e-5, the parity contract, for every tested
group size, with a carried map and without, on ragged M, K and N. A
property test holds the union ring to the contract on random work lists.
The kernels themselves (tensor cores, an exact bf16 split of the
weights) are held on a card in tests/test_torch_cuda.py to their plain
versions, to twice the serial kernels' distance from the fp64 product,
and to each other bit for bit; tests/test_torch_apec_tc.py holds the
split on the CPU.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, st
from repro.core import spikes as jsp
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro_torch.core.events import EventTensor
from repro_torch.core.spikes import pack_spikes_padded
from repro_torch.kernels import apec_kernel, dispatch, launch_counts, ops, \
    reset_launch_counts, spike_matmul

torch.set_num_threads(1)

# (g, M): M ragged (not a multiple of 128) wherever g allows it; at
# g = 128 M must divide by 128, and `repro`'s packed decompose tiles the
# rows by g * 8.
GROUPS = ((1, 300), (2, 300), (4, 300), (16, 304), (128, 1024))
K, N = 200, 70                       # both ragged against 128 and 4


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


def _apec_case(seed, g, m, k=K, n=N):
    """Clustered binary spikes (whole empty 128 x 128 tiles, an all-empty
    m-tile row) where every third group repeats its first member, so the
    overlap holds events. In the first m-tile every group repeats its
    first member at k-tile 0 (an overlap-only step: the residual tile is
    empty) and only each group's first member fires at k-tile 1 (a
    residual-only step where g > 1)."""
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


# ------------------------------------------------- parity with repro
@pytest.mark.parametrize("g,m", GROUPS)
@pytest.mark.parametrize("carried", [False, True])
def test_apec_pipe_matches_repro_pipe_interpret(g, m, carried):
    """`ops.apec_matmul_csr(..., pipeline=True)` and the `cuda-pipe`
    route (an EventTensor carrying the map, or bare spikes) against
    `repro`'s prefetching kernel on the same spikes."""
    s, w = _apec_case(g, g, m)
    ts, tw = torch.from_numpy(s), torch.from_numpy(w)
    occ = ops.padded_occupancy(ts) if carried else None
    want = _jax_quiet(lambda: jops.apec_matmul_csr(
        jnp.asarray(s), jnp.asarray(w), g, pipeline=True,
        occupancy=None if occ is None else jnp.asarray(occ.numpy())))
    got = ops.apec_matmul_csr(ts, tw, g, occupancy=occ, pipeline=True)
    operand = ts if occ is None else EventTensor(ts, occ)
    with dispatch.use_backend(dispatch.CUDA_PIPE, op="apec_matmul"):
        assert dispatch.resolve_attribution("apec_matmul", ts, tw, g=g) == \
            dispatch.CUDA_PIPE
        routed = dispatch.apec_matmul(operand, tw, g=g)
    for out in (got, routed):
        _within_contract(out.numpy(), want)
    _within_contract(got.numpy(), s @ w)
    assert np.all(got.numpy()[128:256] == 0)


@pytest.mark.parametrize("g,m", GROUPS)
@pytest.mark.parametrize("carried", [False, True])
def test_packed_apec_pipe_matches_repro_pipe_interpret(g, m, carried):
    """The packed route (`cuda-packed-pipe` on words with ``packed_k=``)
    against `repro`'s `ops.apec_matmul_packed(..., pipeline=True)`:
    `repro` registers no interpret twin of that kernel, so its wrapper is
    called directly."""
    s, w = _apec_case(100 + g, g, m)
    words = np.asarray(jsp.pack_spikes_padded(jnp.asarray(s)))
    occ = ops.padded_occupancy(torch.from_numpy(s)) if carried else None
    want = _jax_quiet(lambda: jops.apec_matmul_packed(
        jnp.asarray(words), jnp.asarray(w), g, packed_k=K, pipeline=True,
        occupancy=None if occ is None else jnp.asarray(occ.numpy())))
    tw = torch.from_numpy(w)
    got = ops.apec_matmul_packed(_twords(words), tw, g, packed_k=K,
                                 occupancy=occ, pipeline=True)
    with dispatch.use_backend(dispatch.CUDA_PACKED_PIPE, op="apec_matmul"):
        assert dispatch.resolve_attribution(
            "apec_matmul", _twords(words), tw, g=g, packed_k=K) == \
            dispatch.CUDA_PACKED_PIPE
        routed = dispatch.dispatch("apec_matmul", _twords(words), tw, g=g,
                                   packed_k=K, occupancy=occ)
    for out in (got, routed):
        _within_contract(out.numpy(), want)
    _within_contract(got.numpy(), s @ w)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("carried", [False, True])
def test_pipe_plain_versions_equal_the_serial_ones(packed, carried):
    """On the same union work list and counts, the pipelined plain
    versions gate exactly the serial plain versions' operands (their
    products are equal), and plain versions launch nothing."""
    g = 4
    s, w = _apec_case(7, g, 300)
    ts, tw = torch.from_numpy(s), torch.from_numpy(w)
    occ = ops.padded_occupancy(ts) if carried else None
    if packed:
        ov, res = apec_kernel.apec_decompose_packed(pack_spikes_padded(ts), g)
        pipe = spike_matmul.apec_matmul_packed_csr_pipe
        serial = spike_matmul.apec_matmul_packed_csr
    else:
        ov, res = ops.apec_decompose(ts, g)
        pipe, serial = spike_matmul.apec_matmul_csr_pipe, \
            spike_matmul.apec_matmul_csr
    args = (res, ov, tw, g) + ops.apec_union_worklist(res, ov, g, occ,
                                                      packed=packed)
    occ_r, occ_o = args[-2:]
    if not carried:                  # steps live for one operand only
        assert bool(((occ_r > 0) != (occ_o > 0)).any())
    reset_launch_counts()
    assert torch.equal(pipe(*args), serial(*args))
    assert not any(launch_counts().values())


def test_pipeline_flag_selects_the_pipe_kernels(monkeypatch):
    """`pipeline=True` on `ops.apec_matmul_csr` / `ops.apec_matmul_packed`
    reaches the pipe wrappers (as `repro`'s flag selects its prefetching
    kernels), False the serial ones; the registry's pipe routes pass it."""
    seen = []
    for name in ("apec_matmul_csr", "apec_matmul_csr_pipe",
                 "apec_matmul_packed_csr", "apec_matmul_packed_csr_pipe"):
        orig = getattr(spike_matmul, name)
        monkeypatch.setattr(spike_matmul, name,
                            lambda *a, _n=name, _f=orig: (seen.append(_n),
                                                          _f(*a))[1])
    s, w = _apec_case(4, 2, 130, k=64, n=8)
    ts, tw = torch.from_numpy(s), torch.from_numpy(w)
    for pipeline in (False, True):
        ops.apec_matmul_csr(ts, tw, 2, pipeline=pipeline)
        ops.apec_matmul_packed(ts, tw, 2, pipeline=pipeline)
    for name in (dispatch.CUDA_PIPE, dispatch.CUDA_PACKED_PIPE):
        with dispatch.use_backend(name, op="apec_matmul"):
            dispatch.apec_matmul(EventTensor.from_spikes(
                ts, pack=name == dispatch.CUDA_PACKED_PIPE), tw, g=2)
    assert seen == ["apec_matmul_csr", "apec_matmul_packed_csr",
                    "apec_matmul_csr_pipe", "apec_matmul_packed_csr_pipe",
                    "apec_matmul_csr_pipe", "apec_matmul_packed_csr_pipe"]


@pytest.mark.parametrize("packed", [False, True])
def test_pipe_route_grads_match_repro_pipe_jax_grad(packed):
    """Values and gradients through the pipe routes equal `jax.grad` of
    `repro`'s `pallas-csr-pipe-interpret` route on the same spikes,
    weights and cotangent; packed words carry no cotangent, so there only
    dw is compared."""
    g = 2
    s, w = _apec_case(21, g, 2 * 136, k=72, n=40)
    s3 = s.reshape(2, 136, 72)
    cot = np.random.default_rng(22).normal(size=(2, 136, 40)).astype(
        np.float32)

    def jloss(s_, w_):
        with jdispatch.use_backend("pallas-csr-pipe-interpret",
                                   op="apec_matmul"):
            out = jdispatch.apec_matmul(s_, w_, g=g)
        return jnp.sum(out * jnp.asarray(cot)), out
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (_, jout), (jds, jdw) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(s3),
                                                  jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_(True)
    if packed:
        name, operand = dispatch.CUDA_PACKED_PIPE, EventTensor.from_spikes(
            torch.from_numpy(s3), pack=True)
        leaves = (tw,)
    else:
        name = dispatch.CUDA_PIPE
        operand = torch.from_numpy(s3).requires_grad_(True)
        leaves = (operand, tw)
    with dispatch.use_backend(name, op="apec_matmul"):
        out = dispatch.apec_matmul(operand, tw, g=g)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    _within_contract(out.detach().numpy(), jout)
    _within_contract(grads[-1].numpy(), jdw)
    if not packed:
        _within_contract(grads[0].numpy(), jds)


# --------------------------------------------------------- the ring
@given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 2),
                          st.integers(0, 3)), max_size=12),
       st.integers(1, 512), st.integers(2, 4))
def test_union_ring_keeps_the_gate_contract(steps, k, stages):
    """On any union work list (either count 0 or positive, k-tiles past K
    clamped as padding steps are not) and ring depth: a slice for every
    live step and none for a dead one (both counts 0), each operand copied
    exactly where its own count is positive, each slice computed once
    with the flags of its own copies, never more than stages - 1 in
    flight (`check_ring_trace` raises otherwise)."""
    kt = -(-k // 128)
    occ = [r for r, _, _ in steps]
    occ_ov = [o for _, o, _ in steps]
    kidx = [t % kt for _, _, t in steps]
    trace = spike_matmul.ring_schedule(occ, kidx, k, stages, occ_ov=occ_ov)
    computed = spike_matmul.check_ring_trace(trace, occ, kidx, k, stages,
                                             occ_ov=occ_ov)
    issues = [e for e in trace if e[0] == "issue"]
    assert computed == [(e[2], e[3]) for e in issues]
    for _, _, (st_, _), (res, ov) in issues:
        assert (res, ov) == (occ[st_] > 0, occ_ov[st_] > 0) and (res or ov)
    in_flight = 0
    for e in trace:
        in_flight += {"issue": 1, "wait": -1}.get(e[0], 0)
        assert in_flight <= stages - 1
    # With equal counts the union ring issues, waits and computes as the
    # single-gate ring does, in the same slots.
    def bare(trace):
        return [e[:2] if e[0] == "compute" else e[:3] for e in trace]
    assert bare(spike_matmul.ring_schedule(occ, kidx, k, stages,
                                           occ_ov=occ)) == \
        bare(spike_matmul.ring_schedule(occ, kidx, k, stages))


def _broken(kind):
    """A union schedule over steps (res only, dead, ov only, both), with
    one fault put in by hand."""
    occ, occ_ov, kidx, k = [2, 0, 0, 1], [0, 0, 3, 1], [0, 1, 2, 3], 450
    trace = spike_matmul.ring_schedule(occ, kidx, k, occ_ov=occ_ov)
    spike_matmul.check_ring_trace(trace, occ, kidx, k, occ_ov=occ_ov)
    first = next(i for i, e in enumerate(trace) if e[0] == "issue")
    ov_issue = next(i for i, e in enumerate(trace)
                    if e[0] == "issue" and e[2][0] == 2)
    bad = list(trace)
    if kind == "residual copy at occ_res 0":
        e = bad[ov_issue]
        bad[ov_issue] = e[:3] + ((True, True),)
    elif kind == "overlap copy at occ_ov 0":
        e = bad[first]
        bad[first] = e[:3] + ((True, True),)
    elif kind == "slice of a dead step":
        e = bad[first]
        bad[first] = (e[0], e[1], (1, 128), (False, False))
    elif kind == "live operand not copied":
        e = bad[ov_issue]
        bad[ov_issue] = e[:3] + ((False, False),)
    else:                                  # a dot on stale ring contents
        i = next(i for i, e in enumerate(bad) if e[0] == "compute")
        bad[i] = bad[i][:2] + ((True, True),)
    return bad, occ, kidx, k, occ_ov


@pytest.mark.parametrize("kind", ["residual copy at occ_res 0",
                                  "overlap copy at occ_ov 0",
                                  "slice of a dead step",
                                  "live operand not copied",
                                  "compute on stale contents"])
def test_union_ring_check_refuses_a_broken_schedule(kind):
    bad, occ, kidx, k, occ_ov = _broken(kind)
    with pytest.raises(RuntimeError, match="copy ring schedule broken"):
        spike_matmul.check_ring_trace(bad, occ, kidx, k, occ_ov=occ_ov)


# ------------------------------------------------------ the registry
def test_apec_pipe_routes_rank_as_the_reference():
    """`cuda-pipe` / `cuda-packed-pipe` rank above `cuda` / `cuda-packed`
    for `apec_matmul` as `repro`'s pallas-csr-pipe (26) / packed-csr-pipe
    (31) above pallas-csr (25) / packed-csr (30), take the fused routes'
    gate, are differentiable, degrade along cuda-packed-pipe -> cuda-packed
    -> cuda -> cuda-pred and cuda-pipe -> cuda, and are kernel routes."""
    get = dispatch.get_backend
    pipe = get("apec_matmul", dispatch.CUDA_PIPE)
    ppipe = get("apec_matmul", dispatch.CUDA_PACKED_PIPE)
    cuda = get("apec_matmul", dispatch.CUDA)
    packed = get("apec_matmul", dispatch.CUDA_PACKED)
    jget = jdispatch.get_backend
    assert (pipe.priority, ppipe.priority) == (
        jget("apec_matmul", "pallas-csr-pipe").priority,
        jget("apec_matmul", "packed-csr-pipe").priority) == (26, 31)
    assert pipe.priority > cuda.priority and ppipe.priority > packed.priority
    assert (pipe.fallback, ppipe.fallback, packed.fallback, cuda.fallback) \
        == (dispatch.CUDA, dispatch.CUDA_PACKED, dispatch.CUDA,
            dispatch.CUDA_PRED)
    assert pipe.platforms == ppipe.platforms == ("cuda",)
    assert ppipe.payload == ("packed",) and pipe.payload == ("dense",)
    assert pipe.supports is cuda.supports is ppipe.supports
    assert pipe.differentiable and ppipe.differentiable
    assert {dispatch.CUDA_PIPE, dispatch.CUDA_PACKED_PIPE} <= \
        set(dispatch.KERNEL_ROUTES)


def test_card_selection_picks_the_pipe_routes_and_degrades_on_kernels(
        monkeypatch):
    """With the platform read as `cuda`, `apec_matmul` resolves to
    `cuda-pipe` (dense) and `cuda-packed-pipe` (words); where the pipe
    gates refuse, each degrades to the serial kernel of its payload, and
    a group the fused kernels cannot take walks on to the predicated
    kernel, never to a plain route."""
    monkeypatch.setattr(dispatch, "_platform", lambda args: "cuda")
    args, kwargs = dispatch.example_inputs("apec_matmul", "cpu")
    pargs, pkwargs = dispatch._packed_example("apec_matmul",
                                              torch.device("cpu"))
    assert dispatch.resolve_attribution("apec_matmul", *args, **kwargs) == \
        dispatch.CUDA_PIPE
    assert dispatch.resolve_attribution("apec_matmul", *pargs,
                                        **pkwargs) == \
        dispatch.CUDA_PACKED_PIPE
    s, w = torch.zeros(2, 256, 32), torch.zeros(32, 8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert dispatch.resolve_attribution("apec_matmul", s, w, g=256) == \
            "cuda-pred<-cuda-pipe"
        spec = dispatch._REGISTRY["apec_matmul"]
        for name in (dispatch.CUDA_PIPE, dispatch.CUDA_PACKED_PIPE):
            monkeypatch.setitem(spec.backends, name, dataclasses.replace(
                spec.backends[name], supports=lambda *a, **k: "refused"))
        assert dispatch.resolve_attribution("apec_matmul", *args,
                                            **kwargs) == "cuda<-cuda-pipe"
        assert dispatch.resolve_attribution(
            "apec_matmul", *pargs, **pkwargs) == \
            "cuda-packed<-cuda-packed-pipe"
