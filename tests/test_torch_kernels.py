"""repro_torch kernel wrappers and dispatch against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs `repro.kernels.ops` (Pallas in interpret mode), so both sides
walk the same padding, packing, count aggregation and work lists. Spikes,
maps, chunk maps and SDSA words match exactly; CSR matmul outputs within
1e-5. The CUDA kernels themselves are held against their plain versions
in `test_torch_cuda.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.core.spikes import pack_spikes as jpack
from repro.core.spikes import pack_spikes_padded as jpack_padded
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels.sdsa_kernel import sdsa_packed as jsdsa_packed
from repro_torch.core import events as tev
from repro_torch.core.spikes import build_csr, pack_spikes
from repro_torch.kernels import dispatch, launch_counts, ops, \
    reset_launch_counts
from repro_torch.kernels import lif_scan, sdsa_kernel

torch.set_num_threads(1)
ATOL = 1e-5


def _binary(rng, shape, p):
    return (rng.random(shape) < p).astype(np.float32)


def _clustered(rng, m, k, tile_p=0.5, p=0.3, tile=128):
    tiles = rng.random((-(-m // tile), -(-k // tile))) < tile_p
    mask = np.kron(tiles, np.ones((tile, tile)))[:m, :k]
    return (_binary(rng, (m, k), p) * mask).astype(np.float32)


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# --------------------------------------------------------------------- LIF
@pytest.mark.parametrize("shape", [(4, 3, 40), (2, 5, 7, 9)])
def test_lif_wrapper_matches_jax_kernel(shape):
    x = (np.random.default_rng(0).normal(size=shape) * 2).astype(np.float32)
    want = jops.lif(jnp.asarray(x), decay=0.5, v_th=1.0)
    _eq(ops.lif(torch.from_numpy(x), decay=0.5, v_th=1.0), want)


@pytest.mark.parametrize("shape", [(2, 2, 8, 40), (3, 24, 130),
                                   (2, 4, 4, 8, 20)])
def test_lif_occ_maps_match_jax_kernel(shape):
    """Spikes, the (128,128) tile map and the 8-row chunk map: counts, not
    just support."""
    x = (np.random.default_rng(1).normal(size=shape) + 0.6).astype(np.float32)
    ws, wocc, wchunks = jops.lif_occ(jnp.asarray(x), decay=0.5, v_th=1.0)
    s, occ, chunks = ops.lif_occ(torch.from_numpy(x), decay=0.5, v_th=1.0)
    _eq(s, ws)
    _eq(occ, wocc)
    _eq(chunks, wchunks)
    assert occ.dtype == chunks.dtype == torch.int32


def test_lif_counts_plain_matches_jax_count_layout():
    """The (T, R/8, ceil(K/128)) per-chunk layout of _lif_occ_pallas,
    flattened to (T*R/8, ceil(K/128)) chunks of the (T*R, K) rows."""
    from repro.kernels.lif_scan import lif_scan_occ_pallas_sg
    x = (np.random.default_rng(2).normal(size=(3, 16, 256)) + 0.5
         ).astype(np.float32)
    ws, wcnt = lif_scan_occ_pallas_sg(jnp.asarray(x), 0.5, 1.0)
    s, cnt = lif_scan.lif_counts(torch.from_numpy(x), decay=0.5, v_th=1.0)
    _eq(s, ws)
    _eq(cnt, np.asarray(wcnt).reshape(-1, wcnt.shape[-1]))


@pytest.mark.parametrize("shape", [(2, 3, 5, 16), (4, 1, 2, 2, 300),
                                   (3, 12, 130)])
def test_lif_occ_takes_ragged_rows(shape):
    """R % 8 != 0 (VGG11's 2x2 fires at an odd batch): the chunks of the
    flattened rows span steps, and spikes and both maps equal `repro`'s
    `ref` (where `repro` gates its kernel off)."""
    x = (np.random.default_rng(3).normal(size=shape) + 0.6
         ).astype(np.float32)
    want = jdispatch.get_backend("lif_scan_occ", "ref").fn(
        jnp.asarray(x), decay=0.5, v_th=1.0)
    got = ops.lif_occ(torch.from_numpy(x), decay=0.5, v_th=1.0)
    for a, b in zip(got, want):
        _eq(a, b)
    words, occ, chunks = ops.lif_occ(torch.from_numpy(x), decay=0.5,
                                     v_th=1.0, packed=True)
    _eq(words, jpack_padded(jnp.asarray(want[0])))
    _eq(occ, want[1])
    _eq(chunks, want[2])


# ------------------------------------------------------------------ SDSA
@pytest.mark.parametrize("n,d", [(64, 48), (12, 40), (300, 32)])
def test_sdsa_or_matches_jax_kernel(n, d):
    rng = np.random.default_rng(n + d)
    q, k, v = (_binary(rng, (2, 3, n, d), 0.3) for _ in range(3))
    want = jops.sdsa_or(*map(jnp.asarray, (q, k, v)))
    _eq(ops.sdsa_or(*map(torch.from_numpy, (q, k, v))), want)


def test_sdsa_packed_words_match_jax_kernel():
    rng = np.random.default_rng(3)
    q, k, v = (_binary(rng, (6, 16, 64), 0.3) for _ in range(3))
    want = jsdsa_packed(*(jpack(jnp.asarray(a)) for a in (q, k, v)),
                        block_n=16)
    got = sdsa_kernel.sdsa_packed(*(pack_spikes(torch.from_numpy(a))
                                    for a in (q, k, v)))
    np.testing.assert_array_equal(got.view(torch.int32).numpy()
                                  .view(np.uint32), np.asarray(want))


# ------------------------------------------------------------ CSR matmul
@pytest.mark.parametrize("m,k,n", [(256, 256, 128), (300, 200, 60),
                                   (130, 384, 96)])
def test_spike_matmul_csr_matches_jax_kernel(m, k, n):
    rng = np.random.default_rng(m + k + n)
    s = _clustered(rng, m, k)
    w = rng.normal(size=(k, n)).astype(np.float32)
    want = jops.spike_matmul_csr(jnp.asarray(s), jnp.asarray(w))
    got = ops.spike_matmul_csr(torch.from_numpy(s), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def test_spike_matmul_csr_occupancy_passthrough_and_event_operand():
    rng = np.random.default_rng(4)
    s = _clustered(rng, 2 * 160, 200).reshape(2, 160, 200)
    w = rng.normal(size=(200, 70)).astype(np.float32)
    occ = ops.padded_occupancy(torch.from_numpy(s))
    want = jops.spike_matmul_csr(jnp.asarray(s), jnp.asarray(w),
                                 occupancy=jnp.asarray(occ.numpy()))
    got = ops.spike_matmul_csr(torch.from_numpy(s), torch.from_numpy(w),
                               occupancy=occ)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    jet = jev.EventTensor.from_spikes(jnp.asarray(s))
    tet = tev.EventTensor(torch.from_numpy(s),
                          torch.from_numpy(np.array(jet.occupancy)))
    np.testing.assert_allclose(
        ops.spike_matmul_csr(tet, torch.from_numpy(w)).numpy(),
        np.asarray(jops.spike_matmul_csr(jet, jnp.asarray(w))),
        atol=ATOL, rtol=ATOL)


def test_csr_walk_skips_what_the_map_calls_empty():
    """The plain version honours the work list exactly as the kernel does:
    a tile the map calls empty contributes nothing, even if it holds
    events; an all-empty row writes zeros."""
    s = torch.ones(256, 256)
    w = torch.ones(256, 8)
    occ = torch.tensor([[1, 0], [0, 0]], dtype=torch.int32)
    out = ops.spike_matmul_csr(s, w, occupancy=occ)
    assert torch.all(out[:128] == 128) and torch.all(out[128:] == 0)


def test_spike_matmul_csr_rejects_mismatched_maps():
    s, w = torch.zeros(200, 130), torch.zeros(130, 4)
    with pytest.raises(ValueError):
        ops.spike_matmul_csr(s, w, occupancy=torch.zeros(1, 2,
                                                         dtype=torch.int32))
    csr = build_csr(torch.ones(2, 1, dtype=torch.int32), 128, 128)
    with pytest.raises(ValueError):
        ops.spike_matmul_csr(s, w, csr=csr)


# ----------------------------------------------------------------- econv
@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID")])
def test_im2col_patches_match_lax(stride, padding):
    s = _binary(np.random.default_rng(5), (2, 7, 6, 5), 0.3)
    want = jax.lax.conv_general_dilated_patches(
        jnp.asarray(s), (3, 3), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = dispatch.econv_patches(torch.from_numpy(s), 3, 3, stride, padding)
    _eq(got, np.asarray(want).reshape(got.shape))


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME")])
def test_econv_kernel_path_matches_jax(stride, padding):
    """im2col + the CSR walk, fed the propagated patch map, against the
    JAX dense conv and its im2col + CSR backend."""
    rng = np.random.default_rng(6)
    s = _binary(rng, (2, 16, 16, 8), 0.05)
    s[1] = 0
    w = (rng.normal(size=(3, 3, 8, 12)) / 5).astype(np.float32)
    jet = jev.EventTensor.from_spikes(jnp.asarray(s))
    tet = tev.EventTensor(torch.from_numpy(s),
                          torch.from_numpy(np.array(jet.occupancy)),
                          chunks=torch.from_numpy(np.array(jet.chunks)))
    want = jdispatch.econv(jet, jnp.asarray(w), stride=stride,
                           padding=padding)
    with jdispatch.use_backend("pallas-csr-interpret", op="econv"):
        want_csr = jdispatch.econv(jet, jnp.asarray(w), stride=stride,
                                   padding=padding)
    with dispatch.use_backend("cuda"):
        got = dispatch.econv(tet, torch.from_numpy(w), stride=stride,
                             padding=padding)
    ref = dispatch.econv(tet, torch.from_numpy(w), stride=stride,
                         padding=padding)
    for a in (want, want_csr):
        np.testing.assert_allclose(got.numpy(), np.asarray(a), atol=ATOL,
                                   rtol=ATOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


# -------------------------------------------------------------- dispatch
REGISTRY = {"lif_scan": {"ref", "cuda"}, "lif_scan_occ": {"ref", "cuda"},
            "spike_matmul": {"ref", "cuda", "cuda-packed", "cuda-pred",
                             "cuda-pipe", "cuda-packed-pipe"},
            "sdsa": {"ref", "cuda"},
            "causal_sdsa": {"ref", "jnp", "cuda"},
            "econv": {"ref", "cuda", "cuda-packed", "cuda-pred", "jnp",
                      "cuda-pipe", "cuda-packed-pipe"},
            "tconv": {"ref", "cuda", "jnp"},
            "apec_matmul": {"ref", "jnp", "cuda", "cuda-packed",
                            "cuda-pred", "cuda-pipe", "cuda-packed-pipe"}}
MANUAL = {("spike_matmul", "cuda-pred"), ("econv", "cuda-pred"),
          ("econv", "jnp"), ("tconv", "jnp"), ("apec_matmul", "cuda-pred"),
          ("causal_sdsa", "jnp")}
# As in repro, APEC's overlap-reuse form sits above `ref` on every
# platform, so the CPU resolves it there; every other op falls to `ref`.
CPU_RESOLUTION = {op: "ref" for op in REGISTRY} | {"apec_matmul": "jnp"}


def test_cpu_resolves_every_op_to_ref():
    assert dispatch.resolved_backends("cpu") == CPU_RESOLUTION
    assert set(dispatch.op_names()) == set(REGISTRY)
    for op in dispatch.op_names():
        assert set(dispatch.backend_names(op)) == REGISTRY[op]
        for name in REGISTRY[op]:
            assert dispatch.get_backend(op, name).auto == \
                ((op, name) not in MANUAL), (op, name)


@pytest.mark.parametrize("op", sorted(REGISTRY))
def test_every_backend_matches_ref_on_the_same_inputs(op):
    """Each op's example inputs through every registered backend on CPU
    tensors (the kernel routes run their plain versions): fire ops and
    SDSA exactly, the matmul-form ops within 1e-5."""
    args, kwargs = dispatch._REGISTRY[op].make_example(torch.device("cpu"))
    want = dispatch.get_backend(op, "ref").fn(*args, **kwargs)
    for name in dispatch.backend_names(op):
        with dispatch.use_backend(name, op=op):
            got = dispatch.dispatch(op, *args, **kwargs)
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        for a, b in pairs:
            if op in ("lif_scan", "lif_scan_occ", "sdsa", "causal_sdsa"):
                assert torch.equal(a, b), (op, name)
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL,
                                           rtol=ATOL, err_msg=f"{op} {name}")


def test_overrides_context_env_and_per_op(monkeypatch):
    with dispatch.use_backend("cuda"):
        assert set(dispatch.resolved_backends("cpu").values()) == {"cuda"}
        with dispatch.use_backend("ref", op="sdsa"):
            got = dispatch.resolved_backends("cpu")
    assert got["sdsa"] == "ref" and got["econv"] == "cuda"
    monkeypatch.setenv(dispatch.ENV_VAR, "cuda,lif_scan=ref")
    got = dispatch.resolved_backends("cpu")
    assert got["lif_scan"] == "ref" and got["spike_matmul"] == "cuda"


def test_supports_gate_miss_raises_instead_of_degrading(monkeypatch):
    """On the card (the platform read as `cuda`) a refused gate raises
    instead of degrading to a plain route, and so does an unknown
    override name; the same calls on CPU tensors degrade as in `repro`
    (`test_torch_dispatch.py`). A ragged fire has no gate: it runs its
    kernel."""
    monkeypatch.setattr(dispatch, "_platform", lambda args: "cuda")
    q = torch.zeros(2, 4, 8)
    x = torch.zeros(2, 3, 16)
    with pytest.raises(ValueError, match="mode='or'"):
        dispatch.sdsa(q, q, q, mode="sum")
    with dispatch.use_backend("cuda"):
        with pytest.raises(ValueError, match="mode='or'"):
            dispatch.sdsa(q, q, q, mode="sum")
        assert dispatch.resolve_attribution("lif_scan_occ", x) == "cuda"
    with dispatch.use_backend("no-such-backend"), \
            pytest.raises(ValueError, match="not registered"):
        dispatch.lif_scan(torch.zeros(2, 3))


def test_plain_versions_do_not_count_launches():
    reset_launch_counts()
    ops.lif(torch.zeros(2, 8))
    assert set(launch_counts().values()) == {0}
