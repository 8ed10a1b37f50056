"""APEC's decompose on the spikes where they lie (row 19's spike entry)
against the JAX package and against the port's old route, on the CPU.

The same inputs, made with numpy from a seed, go through `repro`'s
`ops.apec_decompose` (pad, pack, its Pallas kernel in interpret mode,
unpack) and the spike entry's plain version
(`apec_kernel.apec_decompose_spikes_plain`), f32 and bf16, for every group
size the fused APEC route takes and ragged widths: overlap and residual
must match exactly. On values other than 0 and 1 the plain version must
equal, bit for bit, the route the port ran before (pad, pack, the word
entry's plain version, unpack), which reads a spike as `s != 0`. The
dense APEC routes (`ops.apec_decompose`, `ops.apec_matmul_csr`,
`ops.apec_matmul`, `core.apec.apec_matmul` with automatic selection as on
the card) make no pack or unpack call. The CUDA kernel is held against
the plain version in `test_torch_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import apec as tapec
from repro_torch.core import events as tev
from repro_torch.core import spikes as core_spikes
from repro_torch.core.spikes import PACK, pack_spikes, unpack_spikes
from repro_torch.kernels import apec_kernel, dispatch, ops, spike_matmul

torch.set_num_threads(1)

GROUPS = (1, 2, 3, 4, 8, 16, 128)
WIDTHS = (1, 31, 32, 37, 384, 432)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# Values a spike tensor might hold besides 0 and 1: -0.0 is no spike,
# everything else (NaN included) is one, as `pack_spikes` reads `!= 0`.
VALUES = np.array([0.0, -0.0, 1.0, 0.5, 2.0, -1.0, np.inf, np.nan],
                  np.float32)


def _grouped(rng, p, c, g, base=0.5, noise=0.3):
    """Binary (p, c) spikes whose groups of g rows share a base pattern
    (so every g has a nonempty overlap) plus per-row noise."""
    shared = rng.random((p // g, 1, c)) < base
    rows = shared | (rng.random((p // g, g, c)) < noise)
    return rows.reshape(p, c).astype(np.float32)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _old_route(s: torch.Tensor, g: int):
    """The port's dense decompose before the spike entry: pad C to whole
    words, pack, the word entry's plain version, unpack, slice."""
    c = s.shape[1]
    sp = torch.nn.functional.pad(s, (0, (-c) % PACK))
    ov, res = apec_kernel.apec_decompose_packed_plain(
        pack_spikes(sp, axis=-1).contiguous(), g)
    return tuple(unpack_spikes(x, axis=-1, dtype=s.dtype)[:, :c]
                 for x in (ov, res))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("g", GROUPS)
def test_spike_plain_matches_jax_decompose(g, c, dtype):
    """The plain version and `ops.apec_decompose` against `repro`'s
    `ops.apec_decompose` (Pallas in interpret mode), exactly."""
    rng = np.random.default_rng(1000 * g + c)
    p = g * (4 if g < 16 else 2)
    s = _grouped(rng, p, c, g)
    tdt, jdt = DTYPES[dtype]
    jov, jres = jops.apec_decompose(jnp.asarray(s, dtype=jdt), g)
    ts = torch.from_numpy(s).to(tdt)
    tov, tres = apec_kernel.apec_decompose_spikes_plain(ts, g)
    assert tov.dtype == tres.dtype == tdt
    assert tuple(tov.shape) == jov.shape == (p // g, c)
    assert tuple(tres.shape) == jres.shape == (p, c)
    for port, ref in ((tov, jov), (tres, jres)):
        np.testing.assert_array_equal(port.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    for a, b in zip(ops.apec_decompose(ts, g), (tov, tres)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
def test_spike_plain_equals_old_route_on_any_values(g, dtype):
    """Bit for bit with pack, word plain version, unpack on -0.0, 0.5,
    2.0, -1.0, inf and NaN; half the groups hold no zero at all, so the
    overlap takes every kind of nonzero."""
    rng = np.random.default_rng(g)
    p, c = 6 * g, 70
    s = VALUES[rng.integers(0, len(VALUES), (p, c))]
    full = rng.random(p // g) < 0.5
    nonzero = VALUES[rng.integers(2, len(VALUES), (p, c))]
    s = np.where(np.repeat(full, g)[:, None], nonzero, s)
    ts = torch.from_numpy(s).to(DTYPES[dtype][0])
    new = apec_kernel.apec_decompose_spikes_plain(ts, g)
    old = _old_route(ts, g)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype == ts.dtype
        assert torch.equal(_bits(a), _bits(b))
    assert new[0].sum().item() > 0


def test_spike_plain_reads_minus_zero_as_no_spike_and_nan_as_one():
    s = torch.tensor([[-0.0, float("nan"), 0.5, 0.0],
                      [-0.0, 2.0, float("-inf"), 1.0]])
    ov, res = apec_kernel.apec_decompose_spikes_plain(s, 2)
    assert ov.tolist() == [[0.0, 1.0, 1.0, 0.0]]
    assert res.tolist() == [[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
    assert torch.equal(_bits(ov), _bits(ov.abs()))     # +0.0, never -0.0


def test_spike_entry_reads_strided_views():
    """A view with a row stride larger than C and one starting inside its
    storage decompose as their contiguous copies."""
    rng = np.random.default_rng(5)
    wide = torch.from_numpy(_grouped(rng, 64, 50, 4))
    for view in (wide[:, 3:40], wide.reshape(-1)[1:1 + 63 * 50].reshape(
            63, 50)[:60]):
        for a, b in zip(apec_kernel.apec_decompose_spikes(view, 4),
                        apec_kernel.apec_decompose_spikes_plain(
                            view.contiguous(), 4)):
            assert torch.equal(a, b)


def test_spike_entry_checks():
    with pytest.raises(ValueError, match="not divisible"):
        apec_kernel.apec_decompose_spikes(torch.zeros(10, 3), 4)
    with pytest.raises(ValueError, match=r"\(P, C\)"):
        apec_kernel.apec_decompose_spikes(torch.zeros(2, 4, 3), 2)
    for dtype in (torch.float64, torch.int32, torch.float16):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            apec_kernel._require_card(torch.zeros(4, 8, dtype=dtype))
    with pytest.raises(ValueError, match="unit-stride"):
        apec_kernel._require_card(torch.zeros(8, 4).t())
    assert apec_kernel._require_card(torch.zeros(4, 8)) == 0
    assert apec_kernel._require_card(torch.zeros(
        4, 8, dtype=torch.bfloat16)) == 1


@pytest.fixture
def pack_calls(monkeypatch):
    """Every pack and unpack call the port's modules make while a test
    runs."""
    calls = []

    def counted(name, fn):
        def wrap(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrap

    for mod in (core_spikes, tev, ops, spike_matmul, dispatch, apec_kernel):
        for name in ("pack_spikes", "pack_spikes_padded", "unpack_spikes",
                     "unpack_spikes_padded"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name,
                                    counted(name, getattr(mod, name)))
    return calls


def _apec_case(g):
    rng = np.random.default_rng(40 + g)
    s = torch.from_numpy(_grouped(rng, 2 * 128, 200, g, 0.3, 0.2)
                         ).reshape(2, 128, 200)
    w = torch.from_numpy(rng.normal(size=(200, 40)).astype(np.float32))
    return s, w


ROUTES = {
    "ops.apec_decompose": lambda s, w, g: ops.apec_decompose(
        s.reshape(-1, s.shape[-1]), g),
    "ops.apec_matmul_csr": lambda s, w, g: ops.apec_matmul_csr(s, w, g),
    "ops.apec_matmul_csr_pipe": lambda s, w, g: ops.apec_matmul_csr(
        s, w, g, pipeline=True),
    "ops.apec_matmul": lambda s, w, g: ops.apec_matmul(s, w, g),
    "core.apec.apec_matmul": lambda s, w, g: tapec.apec_matmul(s, w, g),
    "core.apec.apec_matmul_carried": lambda s, w, g: tapec.apec_matmul(
        tev.EventTensor.from_spikes(s), w, g),
}


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("route", ROUTES)
def test_dense_apec_routes_never_pack(route, g, pack_calls, monkeypatch):
    """With automatic selection as on the card (`core.apec.apec_matmul`
    lands on `cuda-pipe`, whose wrappers run their plain versions here),
    no dense APEC route packs or unpacks, and each equals s @ w within
    1e-5 * max|ref| + 1e-5 (or, for the decompose, the plain version)."""
    monkeypatch.setattr(dispatch, "_platform", lambda args: "cuda")
    s, w = _apec_case(g)
    if route.startswith("core"):
        assert dispatch.resolve_attribution("apec_matmul", s, w, g=g) == \
            dispatch.CUDA_PIPE
    with torch.inference_mode():
        out = ROUTES[route](s, w, g)
    assert pack_calls == []
    if route == "ops.apec_decompose":
        for a, b in zip(out, apec_kernel.apec_decompose_spikes_plain(
                s.reshape(-1, s.shape[-1]), g)):
            assert torch.equal(a, b)
        return
    want = s @ w
    assert tuple(out.shape) == tuple(want.shape)
    assert (out - want).abs().max().item() <= \
        1e-5 * want.abs().max().item() + 1e-5


def test_bf16_spikes_take_the_fused_route():
    """bf16 spikes decompose in bf16 and reach the fused kernel's plain
    version as f32, equal to the f32 spikes' result bit for bit."""
    s, w = _apec_case(2)
    with torch.inference_mode():
        ov, res = ops.apec_decompose(s.reshape(-1, 200).bfloat16(), 2)
        assert ov.dtype == res.dtype == torch.bfloat16
        got = ops.apec_matmul_csr(s.bfloat16(), w, 2, pipeline=True)
        want = ops.apec_matmul_csr(s, w, 2, pipeline=True)
    assert torch.equal(got, want)
