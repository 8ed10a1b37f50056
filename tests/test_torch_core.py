"""repro_torch core (LIF, spike packing, occupancy, TileCSR, EventTensor
map propagation) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
spikes, words, maps, chunk maps and every TileCSR field must match
exactly.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.core import lif as jlif
from repro.core import spikes as jsp
from repro_torch.core import events as tev
from repro_torch.core.econv import conv_pads
from repro_torch.core import lif as tlif
from repro_torch.core import spikes as tsp
from repro_torch.core.surrogate import spike

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _binary(rng, shape, p):
    return (rng.random(shape) < p).astype(np.float32)


def _clustered(rng, m, k, tile_p=0.5, p=0.3, tile=128):
    """Binary (m, k) spikes with whole empty 128x128 tiles."""
    tiles = rng.random((-(-m // tile), -(-k // tile))) < tile_p
    mask = np.kron(tiles, np.ones((tile, tile)))[:m, :k]
    return (_binary(rng, (m, k), p) * mask).astype(np.float32)


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# ------------------------------------------------------------ import guard
def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{f.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


# --------------------------------------------------------------------- LIF
@pytest.mark.parametrize("decay,v_th,soft", [(0.5, 1.0, True),
                                             (0.5, 0.5, False),
                                             (0.25, 0.75, True)])
def test_lif_scan_matches_jax(decay, v_th, soft):
    x = (np.random.default_rng(0).normal(size=(4, 3, 40)) * 1.5
         ).astype(np.float32)
    cfg = dict(decay=decay, v_th=v_th, soft_reset=soft)
    want = jlif.lif_scan(jnp.asarray(x), jlif.LIFConfig(**cfg))
    got = tlif.lif_scan(torch.from_numpy(x), tlif.LIFConfig(**cfg))
    _eq(got, want)


def test_spike_is_heaviside_at_zero():
    v = torch.tensor([-1e-7, 0.0, 1e-7])
    assert spike(v).tolist() == [0.0, 1.0, 1.0]


# ------------------------------------------------------------- packing
@pytest.mark.parametrize("k", [32, 48, 70])
def test_pack_unpack_words_match_jax(k):
    s = _binary(np.random.default_rng(k), (3, 5, k), 0.4)
    want = jsp.pack_spikes_padded(jnp.asarray(s))
    got = tsp.pack_spikes_padded(torch.from_numpy(s))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.view(torch.int32).numpy()
                                  .view(np.uint32), np.asarray(want))
    back = tsp.unpack_spikes(got)[..., :k]
    _eq(back, jsp.unpack_spikes(want)[..., :k])
    assert tsp.packed_width(k) == jsp.packed_width(k)


def test_pack_rejects_ragged_axis():
    with pytest.raises(ValueError):
        tsp.pack_spikes(torch.zeros(2, 33))


# ----------------------------------------------------------- occupancy
def test_tile_occupancy_counts_nonzeros_like_jax():
    rng = np.random.default_rng(1)
    s = _clustered(rng, 256, 384) * rng.random((256, 384)).astype(np.float32)
    _eq(tsp.tile_occupancy(torch.from_numpy(s), 128, 128),
        jsp.tile_occupancy(jnp.asarray(s), 128, 128))
    _eq(tsp.tile_occupancy(torch.from_numpy(s), 8, 128),
        jsp.tile_occupancy(jnp.asarray(s), 8, 128))


def test_prepass_watcher_counts_calls():
    with tsp.watch_occupancy_prepasses() as rec:
        tsp.tile_occupancy(torch.zeros(16, 128), 8, 128)
    assert rec == {"calls": 1, "elements": 16 * 128}


# --------------------------------------------------------------- TileCSR
_MAPS = {
    "mixed": [[0, 3, 0, 1], [0, 0, 0, 0], [2, 0, 0, 0]],
    "all_empty": [[0, 0], [0, 0], [0, 0]],
    "all_full": [[1, 2], [3, 4]],
    "random": np.random.default_rng(2).integers(0, 3, (6, 5)).tolist(),
}
_FIELDS = ("row_ptr", "tile_m_idx", "tile_k_idx", "occ", "valid")


def _csr_eq(port, ref):
    for f in _FIELDS:
        _eq(getattr(port, f), getattr(ref, f))
    assert port.map_shape == tuple(ref.map_shape)
    assert port.tiling == ref.tiling


@pytest.mark.parametrize("name", sorted(_MAPS))
@pytest.mark.parametrize("extra", [0, 3])
def test_concrete_csr_matches_jax(name, extra):
    occ = np.asarray(_MAPS[name], np.int32)
    exact = jsp.occupancy_to_csr(jnp.asarray(occ))
    cap = None if extra == 0 else exact.n_steps + extra
    want = jsp.occupancy_to_csr(jnp.asarray(occ), cap=cap, tiling=(128, 128))
    got = tsp.occupancy_to_csr(torch.from_numpy(occ), cap=cap,
                               tiling=(128, 128), dense_cap=False)
    _csr_eq(got, want)


@pytest.mark.parametrize("name", sorted(_MAPS))
def test_dense_cap_csr_matches_jax_traced_form(name):
    occ = np.asarray(_MAPS[name], np.int32)
    want = jax.jit(lambda o: jsp.occupancy_to_csr(o, tiling=(128, 128)))(
        jnp.asarray(occ))
    got = tsp.occupancy_to_csr(torch.from_numpy(occ), tiling=(128, 128),
                               dense_cap=True)
    _csr_eq(got, want)
    assert got.n_steps == occ.size


@pytest.mark.parametrize("name", sorted(_MAPS))
def test_build_csr_buckets_like_jax(name):
    occ = np.asarray(_MAPS[name], np.int32)
    _csr_eq(tsp.build_csr(torch.from_numpy(occ), 128, 128),
            jsp.build_csr(jnp.asarray(occ), 128, 128))


@pytest.mark.parametrize("n,dense", [(1, 8), (3, 8), (5, 8), (9, 8),
                                     (0, 4), (17, 100)])
def test_pow2_step_cap_matches_jax(n, dense):
    assert tsp.pow2_step_cap(n, dense) == jsp.pow2_step_cap(n, dense)


def test_csr_caps_below_the_required_steps_raise():
    occ = torch.tensor([[1, 1], [0, 0]], dtype=torch.int32)
    with pytest.raises(ValueError):
        tsp.occupancy_to_csr(occ, cap=2, dense_cap=False)
    with pytest.raises(ValueError):
        tsp.occupancy_to_csr(occ, cap=1, dense_cap=True)


def test_csr_rejects_other_tiling_and_grid():
    csr = tsp.occupancy_to_csr(torch.ones(2, 3, dtype=torch.int32),
                               tiling=(128, 128))
    csr.check_compatible(128, 128, 2, 3)
    with pytest.raises(ValueError, match="tiling"):
        csr.check_compatible(64, 128, 2, 3)
    with pytest.raises(ValueError, match="tile grid"):
        csr.check_compatible(128, 128, 2, 4)


# ----------------------------------------------------------- EventTensor
def _event_pair(s):
    """The same spikes as a JAX EventTensor (maps from its chunk pre-pass)
    and as a port EventTensor carrying the very same maps."""
    jet = jev.EventTensor.from_spikes(jnp.asarray(s))
    tet = tev.EventTensor(torch.from_numpy(s),
                          torch.from_numpy(np.array(jet.occupancy)),
                          chunks=torch.from_numpy(np.array(jet.chunks)))
    return jet, tet


def test_reshape_keeps_maps_iff_trailing_axis_survives():
    s = _binary(np.random.default_rng(3), (2, 4, 8, 8, 16), 0.2)
    _, tet = _event_pair(s)
    kept = tet.reshape(8, 8, 8, 16)
    assert kept.occupancy is tet.occupancy and kept.chunks is tet.chunks
    dropped = tet.reshape(2, 4, 64, 2, 8)
    assert dropped.occupancy is None and dropped.chunks is None
    assert torch.equal(dropped.dense().reshape(s.shape), tet.spikes)


def test_occupancy_for_rejects_other_tiling_and_bad_maps():
    s = _binary(np.random.default_rng(4), (16, 40), 0.2)
    _, tet = _event_pair(s)
    assert tet.occupancy_for(128, 128) is tet.occupancy
    with pytest.raises(ValueError):
        tet.occupancy_for(64, 128)
    with pytest.raises(ValueError):
        tev.EventTensor(tet.spikes, torch.zeros(2, 2, dtype=torch.int32))


def test_csr_of_carried_map_is_cached_and_matches_jax():
    s = _clustered(np.random.default_rng(5), 300, 260)
    jet, tet = _event_pair(s)
    csr = tet.csr()
    assert tet.csr() is csr
    _csr_eq(csr, jet.csr())


_WINDOWS = [  # (spike shape, window, stride, padding)
    ((2, 8, 8, 6), (3, 3), 1, "SAME"),
    ((3, 7, 5, 16), (3, 3), 2, "SAME"),
    ((2, 9, 9, 4), (2, 2), 2, "VALID"),
    ((4, 16, 16, 24), (3, 3), 1, "VALID"),
]


@pytest.mark.parametrize("shape,window,stride,padding", _WINDOWS)
@pytest.mark.parametrize("coarse", [False, True])
def test_window_occupancy_matches_jax(shape, window, stride, padding,
                                      coarse):
    rng = np.random.default_rng(sum(shape))
    s = _binary(rng, shape, 0.05)
    s[1:] = 0                     # an all-empty image after the first
    jet, tet = _event_pair(s)
    if coarse:
        jet = jev.EventTensor(jet.spikes, jet.occupancy)
        tet = tev.EventTensor(tet.spikes, tet.occupancy)
    h, w_ = shape[1:3]
    out_hw = tuple(conv_pads(n, k, stride, padding)[0]
                   for n, k in zip((h, w_), window))
    out_k = shape[-1] * window[0] * window[1]
    want = jev.window_occupancy(jet, window, stride, out_hw, out_k, padding)
    got = tev.window_occupancy(tet, window, stride, out_hw, out_k, padding)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID")])
def test_conv_patch_occupancy_matches_jax(stride, padding):
    s = _binary(np.random.default_rng(6), (3, 10, 10, 8), 0.03)
    jet, tet = _event_pair(s)
    w_shape = (3, 3, 8, 12)
    _eq(tev.conv_patch_occupancy(tet, w_shape, stride, padding),
        jev.conv_patch_occupancy(jet, w_shape, stride, padding))


def test_max_pool_events_matches_jax():
    s = _binary(np.random.default_rng(7), (2, 3, 8, 8, 20), 0.1)
    s[:, 1] = 0
    jet, tet = _event_pair(s)
    want = jev.max_pool_events(jet, 2)
    got = tev.max_pool_events(tet, 2)
    _eq(got.spikes, want.spikes)
    _eq(got.occupancy, want.occupancy)
    _eq(got.chunks, want.chunks)
    dense = tev.max_pool_events(torch.from_numpy(s), 2)
    assert isinstance(dense, torch.Tensor) and torch.equal(dense, got.spikes)
