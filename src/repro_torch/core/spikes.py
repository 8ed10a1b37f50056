"""Spike-tensor utilities: bit-packing, popcount, tile occupancy,
CSR-of-tiles.

Packed words cross public boundaries as `torch.uint32` (bit i of word w =
channel w*32 + i, pad bits zero). Shifts, `~` and reductions are not
implemented for uint32 on every PyTorch device, so the arithmetic runs in
int64/int32 and the words are reinterpreted (`.view`) as uint32.

Occupancy maps count events per (tile_m, tile_k) tile of a flattened
(rows, K) spike matrix, from the dense spikes (`tile_occupancy`) or from
the words' popcounts (`packed_tile_occupancy`, 32x fewer bytes read);
`TileCSR` drains a map into the work list the event-compacted CSR matmul
kernel walks.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

PACK = 32  # bits per packed word

# --------------------------------------------------- pre-pass instrumentation
# `tile_occupancy` (and its in-place ragged form) is the standalone dense
# occupancy pre-pass: a full read of a spike-sized tensor just to learn
# which tiles hold events. Between spiking layers the full-event pipeline
# never runs it (the fire stage emits the maps); the watcher stack lets
# tests count the pre-passes a code path paid for.
_PREPASS_WATCHERS: list = []


# The packed payload's own pre-pass (`packed_tile_occupancy`, popcounts of
# the words) is 32x cheaper and is counted apart, so a run can tell where
# no map could be carried without mistaking it for a dense re-scan.
_WORD_PREPASS_WATCHERS: list = []


@contextlib.contextmanager
def _watch(stack: list):
    rec = {"calls": 0, "elements": 0}
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.remove(rec)


def watch_occupancy_prepasses():
    """Context manager yielding a mutable record of `tile_occupancy` calls
    made while active: {"calls": n, "elements": total input elements}."""
    return _watch(_PREPASS_WATCHERS)


def watch_word_prepasses():
    """Context manager yielding a mutable record of word-popcount
    occupancy pre-passes (`packed_tile_occupancy`) made while active:
    {"calls": n, "elements": total input words}."""
    return _watch(_WORD_PREPASS_WATCHERS)


def pack_spikes(s: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a binary {0,1} tensor into uint32 words along `axis`.

    The packed axis length must be a multiple of 32 (pad upstream).
    Bit i of word w corresponds to channel w*32 + i (little-endian).
    """
    s = torch.movedim(s, axis, -1)
    c = s.shape[-1]
    if c % PACK != 0:
        raise ValueError(f"pack axis {c} not a multiple of {PACK}")
    bits = (s.reshape(s.shape[:-1] + (c // PACK, PACK)) != 0).to(torch.int64)
    shifts = torch.arange(PACK, dtype=torch.int64, device=s.device)
    packed = (bits << shifts).sum(-1)
    # Two's-complement wrap into int32, then reinterpret the bits as
    # uint32 (a view: no uint32 arithmetic or casts are needed).
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    return torch.movedim(packed.to(torch.int32).view(torch.uint32), -1, axis)


def unpack_spikes(p: torch.Tensor, axis: int = -1,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of `pack_spikes`."""
    p = torch.movedim(p, axis, -1).contiguous().view(torch.int32)
    p = p.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(PACK, dtype=torch.int64, device=p.device)
    bits = (p.unsqueeze(-1) >> shifts) & 1
    out = bits.reshape(p.shape[:-1] + (p.shape[-1] * PACK,)).to(dtype)
    return torch.movedim(out, -1, axis)


def unpack_spikes_padded(p: torch.Tensor, k: int,
                         dtype=torch.float32) -> torch.Tensor:
    """Inverse of `pack_spikes_padded` along the last axis: the first `k`
    channels of the words."""
    return unpack_spikes(p, axis=-1, dtype=dtype)[..., :k]


def popcount(p: torch.Tensor) -> torch.Tensor:
    """Per-word population count of packed spikes -> int32 of p's shape.
    A SWAR bit count (torch has no popcount op), on the words widened to
    int64 so no shift sign-extends."""
    x = p.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def event_count(s: torch.Tensor) -> torch.Tensor:
    """Total number of active events in a binary spike tensor (a 0-d int
    tensor on s's device: the sum of the spikes as integers, as `repro`
    counts them)."""
    return s.to(torch.int32).sum(dtype=torch.int32)


def sparsity(s: torch.Tensor) -> torch.Tensor:
    """Fraction of zeros (the paper's per-layer 'input sparsity', Fig. 2):
    1 - mean of the spikes in f32, a 0-d tensor on s's device."""
    return 1.0 - s.float().mean()


def to_binary(x: torch.Tensor) -> torch.Tensor:
    """Clamp any tensor to exact {0,1} in its own dtype (defensive)."""
    return (x > 0).to(x.dtype)


def packed_width(k: int) -> int:
    """Number of uint32 words covering `k` bits (ceil division)."""
    return -(-int(k) // PACK)


def pack_spikes_padded(s: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """`pack_spikes` for arbitrary axis lengths: the packed axis is
    zero-padded up to the next multiple of 32, so the last word's high
    bits are guaranteed-zero padding."""
    s = torch.movedim(s, axis, -1)
    pad = (-s.shape[-1]) % PACK
    if pad:
        s = torch.nn.functional.pad(s, (0, pad))
    return torch.movedim(pack_spikes(s, axis=-1), -1, axis)


def packed_tile_occupancy(p: torch.Tensor, tile_m: int, tile_k: int,
                          k: Optional[int] = None) -> torch.Tensor:
    """`tile_occupancy` computed from uint32 words: `p` is a (..., M, KW)
    packed matrix and the map covers the unpacked (M, KW*32) matrix tiled
    (tile_m, tile_k), with the counts `tile_occupancy` gives on the dense
    tensor. `k` (the logical channel count) only validates the word
    width; pad bits are zero by the `pack_spikes_padded` contract. Ticks
    the word pre-pass watchers, never the dense ones."""
    m, kw = p.shape[-2], p.shape[-1]
    if k is not None and packed_width(k) != kw:
        raise ValueError(f"packed width {kw} words does not cover k={k} "
                         f"(want {packed_width(k)})")
    if tile_k % PACK:
        raise ValueError(f"tile_k {tile_k} not a multiple of {PACK}")
    if m % tile_m or kw % (tile_k // PACK):
        raise ValueError(f"packed shape ({m},{kw}) not tileable by "
                         f"({tile_m},{tile_k // PACK})")
    occ = ragged_packed_tile_occupancy(p.reshape(-1, kw), tile_m, tile_k)
    return occ.reshape(tuple(p.shape[:-2]) + (m // tile_m,
                                              kw * PACK // tile_k))


def ragged_packed_tile_occupancy(p: torch.Tensor, tile_m: int,
                                 tile_k: int) -> torch.Tensor:
    """`packed_tile_occupancy` of an (M, KW) word matrix zero-padded to the
    tiling, counted in place (ragged edge tiles count what they hold) ->
    (ceil(M/tile_m), ceil(KW*32/tile_k)) int32."""
    m, kw = p.shape
    for rec in _WORD_PREPASS_WATCHERS:
        rec["calls"] += 1
        rec["elements"] += p.numel()
    per = tile_k // PACK
    cnt = popcount(p)
    cnt = torch.nn.functional.pad(cnt, (0, (-kw) % per, 0, (-m) % tile_m))
    return cnt.reshape(cnt.shape[0] // tile_m, tile_m, -1, per).sum(
        dim=(1, 3), dtype=torch.int32)


def tile_occupancy(s: torch.Tensor, tile_m: int, tile_k: int) -> torch.Tensor:
    """Occupancy map over an (M, K) spike matrix tiled (tile_m, tile_k):
    an int32 (M/tile_m, K/tile_k) tensor of per-tile event counts. Counts
    nonzeros, not a sum, so fractional drive never reads as an empty
    tile."""
    m, k = s.shape[-2], s.shape[-1]
    if m % tile_m or k % tile_k:
        raise ValueError(f"shape ({m},{k}) not tileable by ({tile_m},{tile_k})")
    # Whole row tiles never straddle two leading-axis slices, so the
    # slices fold into rows and the map unfolds again.
    occ = ragged_tile_occupancy(s.reshape(-1, k), tile_m, tile_k)
    return occ.reshape(tuple(s.shape[:-2]) + (m // tile_m, k // tile_k))


def occupancy_fraction(s: torch.Tensor, tile_m: int,
                       tile_k: int) -> torch.Tensor:
    """Fraction of non-empty tiles of `tile_occupancy` (predicts the
    tile-skip speedup), a 0-d f32 tensor on s's device."""
    return (tile_occupancy(s, tile_m, tile_k) > 0).float().mean()


def ragged_tile_occupancy(s: torch.Tensor, tile_m: int,
                          tile_k: int) -> torch.Tensor:
    """`tile_occupancy` of an (M, K) matrix zero-padded to the tiling,
    counted in place: the ragged edge tiles count the events they hold,
    which is what the padded copy would count (padding adds zeros), so
    the map is identical without the copy. -> (ceil(M/tile_m),
    ceil(K/tile_k)) int32."""
    m, k = s.shape
    for rec in _PREPASS_WATCHERS:
        rec["calls"] += 1
        rec["elements"] += s.numel()
    kf = k - k % tile_k
    per_row = [torch.count_nonzero(
        s[:, :kf].unflatten(1, (kf // tile_k, tile_k)), dim=-1)]
    if kf < k:
        per_row.append(torch.count_nonzero(s[:, kf:], dim=-1)[:, None])
    per_row = torch.cat(per_row, dim=1)                   # (M, KT) counts
    per_row = torch.nn.functional.pad(per_row, (0, 0, 0, (-m) % tile_m))
    return per_row.reshape(-1, tile_m, per_row.shape[1]).sum(
        dim=1, dtype=torch.int32)


class TileCSR(NamedTuple):
    """CSR-of-tiles work list: one step per occupied (m-tile, k-tile),
    row-major, plus one dummy step (k-tile 0, occ 0) for each m-tile row
    with no occupied tile, so its output is still written (as zeros).

      row_ptr     (MT+1,) int32 — row i's steps are row_ptr[i]:row_ptr[i+1]
      tile_m_idx  (cap,)  int32 — m-tile index per step
      tile_k_idx  (cap,)  int32 — k-tile index per step
      occ         (cap,)  int32 — per-step event count, 0 on dummy and
                  padding steps
      valid       (cap,)  int32 — 1 on real steps, 0 on padding
      tiling      (tile_m, tile_k) it was built for, or None
      map_shape   (MT, KT) of the map it was compacted from

    Steps past row_ptr[-1] are padding that repeats the last real step's
    indices; the CUDA kernel walks row ranges and never reaches them.
    """
    row_ptr: torch.Tensor
    tile_m_idx: torch.Tensor
    tile_k_idx: torch.Tensor
    occ: torch.Tensor
    valid: torch.Tensor
    tiling: Optional[tuple] = None
    map_shape: Optional[tuple] = None

    @property
    def n_steps(self) -> int:
        return self.tile_k_idx.shape[0]

    @property
    def n_rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    def check_compatible(self, tile_m: int, tile_k: int,
                         mt: int, kt: int) -> None:
        """Raise when this CSR was built for another tiling or another
        (MT, KT) tile grid: its step indices would gate the wrong tiles
        silently. Skipped per tag for untagged CSRs."""
        for got, want, what in ((self.tiling, (tile_m, tile_k), "tiling"),
                                (self.map_shape, (mt, kt), "tile grid")):
            if got is not None and tuple(got) != want:
                raise ValueError(
                    f"TileCSR built for {what} {tuple(got)} used with "
                    f"{what} {want}")


def occupancy_to_csr(occ: torch.Tensor, cap: Optional[int] = None,
                     tiling: Optional[tuple] = None, *,
                     dense_cap: Optional[bool] = None) -> TileCSR:
    """Compact a (MT, KT) per-tile occupancy map into a `TileCSR`.

    Two forms, as in `repro`:
      * concrete (`dense_cap=False`): the map is read on the host (numpy
        `nonzero`) and `cap` defaults to the exact step count;
      * dense-cap (`dense_cap=True`): the compaction stays on the map's
        device with no host sync (a stable sort puts the set steps first),
        `cap` defaults to MT*KT and trailing padding steps clamp to the
        last real step.
    `dense_cap=None` picks dense-cap for CUDA maps (a host sync per matmul
    would stall the launch queue) and concrete otherwise.
    """
    mt, kt = occ.shape
    if dense_cap is None:
        dense_cap = occ.is_cuda
    if not dense_cap:
        occ_np = occ.detach().cpu().numpy()
        mask = occ_np > 0
        mask2 = mask.copy()
        mask2[:, 0] |= ~mask.any(axis=1)          # dummy step per empty row
        flat = np.nonzero(mask2.ravel())[0]
        total = len(flat)
        if cap is None:
            cap = total
        elif cap < total:
            raise ValueError(f"cap {cap} < required steps {total}")
        steps = np.concatenate(
            [flat, np.full(cap - total, flat[-1], np.int64)])
        valid = (np.arange(cap) < total).astype(np.int32)
        row_ptr = np.concatenate(
            [[0], np.cumsum(mask2.sum(axis=1))]).astype(np.int32)
        occ_steps = occ_np.ravel()[steps].astype(np.int32) \
            * mask.ravel()[steps] * valid
        fields = (row_ptr, (steps // kt).astype(np.int32),
                  (steps % kt).astype(np.int32), occ_steps.astype(np.int32),
                  valid)
        return TileCSR(*(torch.from_numpy(np.ascontiguousarray(f))
                         .to(occ.device) for f in fields), tiling, (mt, kt))
    if cap is None:
        cap = mt * kt
    elif cap < mt:
        # Every m-tile row needs at least its dummy step, or its output
        # block is never written.
        raise ValueError(
            f"cap {cap} < {mt} m-tile rows: every row needs >= 1 step "
            f"(dummy steps zero all-empty rows' output blocks)")
    mask = occ > 0
    mask2 = mask.clone()
    mask2[:, 0] |= ~mask.any(dim=1)
    flat_mask = mask2.reshape(-1)
    # Set steps first, each group in ascending order: nonzero() without the
    # host sync that its data-dependent length would cost.
    order = torch.argsort((~flat_mask).to(torch.int8), stable=True)
    if cap <= order.shape[0]:
        flat = order[:cap]
    else:
        flat = torch.cat([order, order.new_zeros(cap - order.shape[0])])
    total = flat_mask.sum()
    last = flat[(total - 1).clamp(min=0).reshape(1)]
    arange = torch.arange(cap, device=occ.device)
    live = arange < total
    steps = torch.where(live, flat, last)        # clamp padding
    row_ptr = torch.cat([mask2.new_zeros(1, dtype=torch.int32),
                         torch.cumsum(mask2.sum(dim=1), 0).to(torch.int32)])
    occ_steps = (occ.reshape(-1)[steps] * mask.reshape(-1)[steps] * live)
    return TileCSR(row_ptr, (steps // kt).to(torch.int32),
                   (steps % kt).to(torch.int32), occ_steps.to(torch.int32),
                   live.to(torch.int32), tiling, (mt, kt))


def tile_csr(s: torch.Tensor, tile_m: int, tile_k: int,
             cap: Optional[int] = None) -> TileCSR:
    """Occupancy pre-pass + CSR compaction of an (M, K) spike matrix
    (`occupancy_to_csr`: a CUDA matrix's map compacts on the card,
    dense-cap, with no host read)."""
    return occupancy_to_csr(tile_occupancy(s, tile_m, tile_k), cap=cap,
                            tiling=(tile_m, tile_k))


def build_csr(occ: torch.Tensor, block_m: int, block_k: int) -> TileCSR:
    """Occupancy map -> `TileCSR` work list. CUDA maps keep the dense cap
    (no host sync); host maps trim to the occupied tiles and bucket the
    step count at a power of two (`pow2_step_cap`), as `repro` does for
    concrete maps."""
    tiling = (block_m, block_k)
    if occ.is_cuda:
        return occupancy_to_csr(occ, tiling=tiling, dense_cap=True)
    exact = occupancy_to_csr(occ, tiling=tiling, dense_cap=False)
    mt, kt = occ.shape
    cap = pow2_step_cap(exact.n_steps, mt * kt)
    if cap == exact.n_steps:
        return exact
    return occupancy_to_csr(occ, cap=cap, tiling=tiling, dense_cap=False)


def pow2_step_cap(n_steps: int, dense: int) -> int:
    """Round a CSR step count up to the next power of two, capped at the
    dense bound."""
    n_steps = max(1, int(n_steps))
    return min(int(dense), 1 << (n_steps - 1).bit_length())
