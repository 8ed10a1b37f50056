"""The reference's last public helpers in the port, against the JAX
package on the CPU: the AER stream helpers of `core.events`,
`lif_scan_with_state` / `multistep_lif`, `ops.sdsa_status` (TPU row 7's
status-only entry) with its spike and word entries, `ref.sdsa_unpacked_ref`
and `mlp_apply` on an `EventTensor`.

Inputs are made with numpy from a seed and handed to both packages. The
helpers, the fires, the status and the unpacked SDSA are exact; the MLP
is within 1e-5 of max|ref| (fp32 summation order in its matmuls). The
status instance of `csrc/sdsa.cu` cannot run here: its index arithmetic
is emulated thread by thread from the descriptor the wrapper builds (as
tests/test_torch_sdsa.py emulates the OR form), every output element
written once and equal to the plain version.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.core import lif as jlif
from repro.core.lif import LIFConfig as JLIFConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sdsa_kernel import sdsa_status_pallas
from repro.models import layers as jlayers
from repro_torch.core import events as tev
from repro_torch.core import lif as tlif
from repro_torch.core.events import EventTensor
from repro_torch.core.lif import LIFConfig
from repro_torch.core.spikes import watch_occupancy_prepasses
from repro_torch.kernels import dispatch, ops, ref, sdsa_kernel
from repro_torch.models import layers
from test_torch_sdsa import (LAYOUTS, _as_out, _flat, _layout_inputs,
                             _row_offsets, _unit_masks, _write_units)

torch.set_num_threads(1)
WORDS = [0, 0xFFFFFFFF, 0b10110, 1 << 31, 0x80000001, 0x0F0F0F0F,
         0xDEADBEEF]


def _binary(rng, shape, p):
    return (rng.random(shape) < p).astype(np.float32)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.float().numpy() if got.is_floating_point()
                                  else got.numpy(), np.asarray(want))


# ----------------------------------------------------- AER stream helpers
@pytest.mark.parametrize("width", [32, 8])
def test_fast_event_filter_matches_jax(width):
    for w in WORDS:
        want = jev.fast_event_filter(jnp.uint32(w), width)
        _eq(tev.fast_event_filter(w, width), want)
        word = torch.tensor([w], dtype=torch.int64).to(torch.int32) \
            if w < 2 ** 31 else torch.tensor([w - 2 ** 32], dtype=torch.int32)
        _eq(tev.fast_event_filter(word.view(torch.uint32)[0], width), want)
    got = tev.fast_event_filter(torch.tensor(WORDS, dtype=torch.int64), width)
    assert got.shape == (len(WORDS), width) and got.dtype == torch.int32
    for row, w in zip(got, WORDS):
        _eq(row, jev.fast_event_filter(jnp.uint32(w), width))


@pytest.mark.parametrize("max_events", [0, 7, 40, 128])
def test_to_event_stream_truncates_and_pads_like_jax(max_events):
    s = _binary(np.random.default_rng(1), (4, 4, 8), 0.3)   # 40 events
    s[0, 0, 0] = -0.0
    want = jev.to_event_stream(jnp.asarray(s), max_events)
    got = tev.to_event_stream(torch.from_numpy(s), max_events)
    assert got.addr.dtype == torch.int32 and got.valid.dtype == torch.bool
    _eq(got.addr, want.addr)
    _eq(got.valid, want.valid)


@pytest.mark.parametrize("shape", [(2, 5, 37), (3, 64), (1, 2, 3, 96)])
def test_counts_and_report_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    s = _binary(rng, shape, 0.3)
    ints = rng.integers(0, 3, shape).astype(np.float32)
    for x in (s, ints):
        got = tev.events_per_position(torch.from_numpy(x))
        assert got.dtype == torch.int32
        _eq(got, jev.events_per_position(jnp.asarray(x)))
    if shape[-1] % 32 == 0:
        got = tev.word_event_counts(torch.from_numpy(s))
        assert got.dtype == torch.int32
        _eq(got, np.asarray(jev.word_event_counts(jnp.asarray(s))))
    moved = np.moveaxis(s, -1, 0).copy()
    if moved.shape[0] % 32 == 0:
        _eq(tev.word_event_counts(torch.from_numpy(moved), axis=0),
            np.asarray(jev.word_event_counts(jnp.asarray(moved), axis=0)))
    assert tev.layer_sparsity_report("l", torch.from_numpy(s)) == \
        jev.layer_sparsity_report("l", jnp.asarray(s))


def test_word_event_counts_of_full_and_empty_words():
    s = np.zeros((2, 64), np.float32)
    s[0, :32] = 1.0
    s[1, 40] = 1.0
    _eq(tev.word_event_counts(torch.from_numpy(s)), [[32, 0], [0, 1]])


# ------------------------------------------------------------------ LIF
@pytest.mark.parametrize("soft,v_th", [(True, 1.0), (False, 0.5)])
def test_lif_scan_with_state_and_multistep_match_jax(soft, v_th):
    rng = np.random.default_rng(7)
    x = rng.normal(0.4, 1.0, (4, 3, 37)).astype(np.float32)
    v0 = rng.normal(0.0, 0.5, (3, 37)).astype(np.float32)
    jcfg = JLIFConfig(v_th=v_th, soft_reset=soft)
    tcfg = LIFConfig(v_th=v_th, soft_reset=soft)
    v_want, s_want = jlif.lif_scan_with_state(jnp.asarray(x),
                                              jnp.asarray(v0), jcfg)
    v_got, s_got = tlif.lif_scan_with_state(torch.from_numpy(x),
                                            torch.from_numpy(v0), tcfg)
    _eq(v_got, v_want)
    _eq(s_got, s_want)
    _eq(tlif.multistep_lif(torch.from_numpy(x), tcfg),
        jlif.multistep_lif(jnp.asarray(x), jcfg))


# ---------------------------------------------------------- SDSA status
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 37, 40), (1, 64, 32), (4, 9, 70),
                                   (2, 8, 64)])
def test_sdsa_status_matches_jax_exactly(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    k = _binary(rng, shape, 0.2)
    v = _binary(rng, shape, 0.3)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jops.sdsa_status(jnp.asarray(k, jdt), jnp.asarray(v, jdt))
    tk, tv = (torch.from_numpy(a).to(dtype) for a in (k, v))
    got = ops.sdsa_status(tk, tv)
    assert got.dtype == dtype and got.shape == shape[:-2] + shape[-1:]
    _eq(got, np.asarray(want, dtype=np.float32))
    _eq(sdsa_kernel.sdsa_status_spikes(tk, tv), np.asarray(want, np.float32))


@pytest.mark.parametrize("bh,n,dw", [(3, 40, 2), (1, 64, 1), (5, 8, 3)])
def test_sdsa_status_words_match_the_pallas_kernel(bh, n, dw):
    rng = np.random.default_rng(bh * n + dw)
    # About one bit in eight set, so the status is neither empty nor full.
    k, v = (np.bitwise_and.reduce(rng.integers(0, 2 ** 32, (3, bh, n, dw),
                                               dtype=np.uint64))
            for _ in range(2))
    k[0, 0, 0], v[0, 0, 0] = 0xFFFFFFFF, 0xFFFFFFFF
    k[-1, :, -1] = 0
    k, v = k.astype(np.uint32), v.astype(np.uint32)
    want = sdsa_status_pallas(jnp.asarray(k), jnp.asarray(v), block_n=8,
                              interpret=True)
    got = sdsa_kernel.sdsa_status_words(
        *(torch.from_numpy(a.view(np.int32)).view(torch.uint32)
          for a in (k, v)))
    want = np.asarray(want)
    assert np.any(want != 0xFFFFFFFF)
    np.testing.assert_array_equal(got.view(torch.int32).numpy().view(
        np.uint32), want)


def test_sdsa_unpacked_ref_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (_binary(rng, (2, 3, 19, 40), p) for p in (0.5, 0.2, 0.3))
    want = jref.sdsa_unpacked_ref(*map(jnp.asarray, (q, k, v)))
    got = ref.sdsa_unpacked_ref(*map(torch.from_numpy, (q, k, v)))
    _eq(got, want)
    _eq(ops.sdsa_or(*map(torch.from_numpy, (q, k, v))), want)


def _emulate_status(k, v, words=False) -> torch.Tensor:
    """csrc/sdsa.cu's status instance on the wrapper's descriptor: pass 1
    and the OR of the token groups, then group 0 writes the status."""
    out = torch.empty(k.shape[:-2] + k.shape[-1:], dtype=k.dtype)
    wide = out.unsqueeze(-2).expand(k.shape)
    ops4 = (k, k, v, wide)
    vec, units, lay = sdsa_kernel._describe(
        tuple(x[None] for x in ops4) if words else ops4, False)
    assert lay[10 + 5 * 3] == 0            # the status has no token stride
    elems = 16 // k.element_size() if vec else 1
    n, rows = lay[4], math.prod(lay[1:4])
    sn = [lay[10 + 5 * o] for o in range(4)]
    ub = sdsa_kernel.unit_block(units)
    groups = sdsa_kernel.or_groups(ub, n)
    threads = sdsa_kernel.THREADS
    per_row = ub * groups
    view = (lambda x: x.view(torch.int32)) if words else (lambda x: x)
    fk, fv = _flat(view(k)), _flat(view(v))
    wk = fk if not words else k.view(torch.int32).reshape(-1).numpy()
    wv = fv if not words else v.view(torch.int32).reshape(-1).numpy()
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
               x.storage_offset() for o, x in enumerate(ops4)]
        c = unit * elems
        status = np.zeros(threads, dtype=np.int64)
        for tok in range(n):
            mine = live & (tok % groups == grp)
            if words:
                ik = np.where(mine, off[1] + tok * sn[1] + c, 0)
                iv = np.where(mine, off[2] + tok * sn[2] + c, 0)
                status |= np.where(mine, wk[ik].astype(np.int64) &
                                   wv[iv].astype(np.int64), 0)
            else:
                status |= _unit_masks(fk, off[1] + tok * sn[1], c, elems,
                                      mine) & \
                    _unit_masks(fv, off[2] + tok * sn[2], c, elems, mine)
        status = np.bitwise_or.reduce(
            status.reshape(-1, groups, ub), axis=1)[rb, u]
        first = live & (grp == 0)
        if words:
            idx = (off[3] + c)[first]
            np.add.at(writes, idx, 1)
            res[idx] = status[first]
        else:
            _write_units(res, writes, off[3], c, elems, status, first)
    if words:
        assert bool((writes == 1).all()), "a status word written != once"
        return torch.from_numpy(res & 0xFFFFFFFF).reshape(out.shape)
    return _as_out(res, writes, out)


@pytest.mark.parametrize("shape,dtype,offset", LAYOUTS)
def test_status_kernel_emulation_equals_plain(shape, dtype, offset):
    _, k, v = _layout_inputs(shape, dtype, offset, sum(shape) + 3)
    want = sdsa_kernel.sdsa_status_spikes_plain(k, v)
    assert torch.equal(_emulate_status(k, v), want)


@pytest.mark.parametrize("shape,dtype", [((4, 2, 64, 8, 48), torch.float32),
                                         ((2, 300, 16, 64), torch.bfloat16)])
def test_status_takes_the_or_forms_plan(shape, dtype):
    """The status instance's descriptor is the OR form's on the same K, V
    views (SpikingFormer's attention, whisper's head-joined fold) but for
    the status's token stride 0."""
    k, q, v = (torch.zeros(shape, dtype=dtype).transpose(-3, -2)
               for _ in range(3))
    wide = torch.empty(k.shape[:-2] + k.shape[-1:],
                       dtype=dtype).unsqueeze(-2).expand(k.shape)
    _, status, _ = sdsa_kernel._prepared(False, False, k, k, v, wide)
    _, full, _ = sdsa_kernel._prepared(False, False, q, k, v,
                                       torch.empty_like(q))
    _, units, lay = sdsa_kernel._describe((k, k, v, wide), False)
    ub = sdsa_kernel.unit_block(units)
    assert list(status)[:4] == list(full)[:4]
    assert list(status)[2:4] == [ub, sdsa_kernel.or_groups(ub, lay[4])]


@pytest.mark.parametrize("shape", [(1, 300, 8, 64), (1, 90, 3, 40)])
def test_status_emulation_at_the_long_folds(shape):
    rng = np.random.default_rng(sum(shape))
    k, v = (torch.from_numpy(_binary(rng, shape, 0.02)).to(
        torch.bfloat16).transpose(-3, -2) for _ in range(2))
    want = sdsa_kernel.sdsa_status_spikes_plain(k, v)
    assert 0 < want.float().mean() < 1
    assert torch.equal(_emulate_status(k, v), want)


def test_status_word_entry_emulation_equals_plain():
    rng = np.random.default_rng(11)

    def sparse_words():           # about one bit in eight set
        w = rng.integers(0, 2 ** 32, (3, 6, 37, 3), dtype=np.uint64)
        w = (w[0] & w[1] & w[2]).astype(np.uint32)
        return torch.from_numpy(w.view(np.int32)).view(torch.uint32)
    k, v = sparse_words(), sparse_words()
    want = sdsa_kernel.sdsa_status_words_plain(k, v).view(torch.int32)
    got = _emulate_status(k, v, words=True)
    np.testing.assert_array_equal(got.numpy(),
                                  want.numpy().astype(np.int64) & 0xFFFFFFFF)


# ------------------------------------------------- the MLP on events
def _mlp_case(seed=0, shape=(2, 2, 16, 64), d_ff=256):
    rng = np.random.default_rng(seed)
    x = _binary(rng, shape, 0.25)
    d = shape[-1]
    scale = (2.0 / (d + d_ff)) ** 0.5
    p = {"w_gate": rng.normal(0, scale, (d, d_ff)).astype(np.float32),
         "w_up": rng.normal(0, scale, (d, d_ff)).astype(np.float32),
         "w_down": rng.normal(0, scale, (d_ff, d)).astype(np.float32)}
    return x, p


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("card_routes", [False, True])
def test_mlp_apply_on_event_tensors_matches_jax(packed, card_routes,
                                                monkeypatch):
    """Dense and packed carried maps, on the CPU's automatic routes and
    on the card's (the platform read as `cuda`: `cuda-pipe` /
    `cuda-packed-pipe` and the counts fire, their plain versions here):
    within 1e-5 of JAX's `mlp_apply` on its EventTensor, the hidden fire
    re-emitting its map (no occupancy pre-pass in the block)."""
    x, p = _mlp_case()
    want = jlayers.mlp_apply(
        {k: jnp.asarray(w) for k, w in p.items()},
        jev.EventTensor.from_spikes(jnp.asarray(x), pack=packed), True,
        JLIFConfig(v_th=0.5))
    if card_routes:
        monkeypatch.setattr(dispatch, "_platform", lambda args: "cuda")
    et = EventTensor.from_spikes(torch.from_numpy(x), pack=packed)
    fired = []
    orig = layers.lif_fire_events

    def rec(h, cfg, packed=False):
        out = orig(h, cfg, packed=packed)
        fired.append((out.is_packed, out.occupancy is not None))
        return out
    monkeypatch.setattr(layers, "lif_fire_events", rec)
    with watch_occupancy_prepasses() as pre, torch.no_grad():
        got = layers.mlp_apply({k: torch.from_numpy(w) for k, w in p.items()},
                               et, True, LIFConfig(v_th=0.5))
    assert fired == [(packed, True)]
    # The card's fire counts its own spikes; `ref`'s re-derives the map.
    assert pre["calls"] == (0 if card_routes else 1)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max() + 1e-5, err


def test_mlp_apply_on_events_equals_the_dense_spiking_form():
    x, p = _mlp_case(seed=3)
    tp = {k: torch.from_numpy(w) for k, w in p.items()}
    cfg = LIFConfig(v_th=0.5)
    with torch.no_grad():
        dense = layers.mlp_apply(tp, torch.from_numpy(x), True, cfg)
        for packed in (False, True):
            got = layers.mlp_apply(
                tp, EventTensor.from_spikes(torch.from_numpy(x), pack=packed),
                True, cfg)
            err = (got - dense).abs().max().item()
            assert err <= 1e-5 * dense.abs().max().item() + 1e-5, err
