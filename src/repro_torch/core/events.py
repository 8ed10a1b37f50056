"""EventTensor — the full-event inter-layer carrier.

Binary spikes, or their uint32 words, plus the per-tile occupancy map the
fused fire kernel emitted while writing them, its 8-row chunk refinement,
and (lazily) the map's `TileCSR`. Consumers take an EventTensor in place
of a dense spike tensor and skip their own occupancy pre-pass.

Occupancy contract (as in `repro.core.events`): `occupancy[i, j]` covers
tile (i, j) of the zero-padded (rows, K) = (prod(shape[:-1]), shape[-1])
flattening of the spikes under `tiling`. Counts are upper bounds with an
exact zero set: a zero guarantees the tile holds no events, while
propagated maps (`window_occupancy`) may over-count. `chunks` holds the
same counts per (8-row, tile_k-lane) block, shape (MT*16, KT); only window
propagation reads it.

Survival rules: a reshape that keeps the trailing axis keeps the maps;
one that changes it drops them. Conv im2col and pooling propagate the
maps through `window_occupancy` on the small map, never by re-scanning
the spikes.

Packed payload: `packed` holds uint32 words along the channel axis (bit
i of word w = channel 32w+i, zero pad bits), shape spikes.shape[:-1] +
(ceil(K/32),). A packed-only tensor (`spikes=None`, `is_packed`) records
the logical channel count and dtype in `feature_size` / `spike_dtype`,
and nothing densifies it silently: `dense()` is the one explicit unpack,
dispatch routes its words to the packed backends, a reshape that changes
the trailing axis raises, and max-pooling ORs the words. The words are
integer metadata for autograd: packed mode is an inference path.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .econv import conv_pads
from .spikes import (build_csr, pack_spikes, pack_spikes_padded,
                     packed_width, popcount, tile_occupancy,
                     unpack_spikes_padded)

CHUNK = 8    # fine-map row granularity: the fire kernel's row chunk


# ======================================================================
# AER streams — the Sparse Core's view (Sec. III, Fig. 4)
# ======================================================================
# The reference event-filter semantics, for tests and for instrumentation
# that needs exact per-word event counts. Counts are int32.
class EventStream(NamedTuple):
    """Padded AER stream: linear addresses + validity mask."""
    addr: torch.Tensor   # (max_events,) int32 linear index into the flat map
    valid: torch.Tensor  # (max_events,) bool


def fast_event_filter(word, width: int = 32) -> torch.Tensor:
    """Reference of the hardware fast event filter on a packed word
    (a Python int or a uint32 / integer tensor; a tensor of words gives
    one row a word).

    Emits the bit positions of set bits in ascending order (lowest active
    bit first — the one-hot + LUT scheme), padded with -1. Static output
    length = `width`; positions from 32 up read zero bits."""
    w = torch.as_tensor(word)
    if w.dtype == torch.uint32:
        w = w.view(torch.int32)
    w = w.to(torch.int64) & 0xFFFFFFFF
    positions = torch.arange(width, dtype=torch.int64, device=w.device)
    set_mask = ((w[..., None] >> positions) & 1).bool() & (positions < 32)
    # Set bits keep their position, clear ones sort after every set one.
    order = torch.where(set_mask, positions, positions + width)
    ordered = order.sort(dim=-1).values
    return torch.where(ordered < width, ordered, -1).to(torch.int32)


def to_event_stream(s: torch.Tensor, max_events: int) -> EventStream:
    """Flatten a binary tensor into a padded AER stream (raster order):
    the first `max_events` nonzero addresses, ascending, padded with -1."""
    lin = torch.nonzero(s.reshape(-1)).reshape(-1)[:max_events]
    addr = torch.full((max_events,), -1, dtype=torch.int32, device=s.device)
    addr[:lin.numel()] = lin.to(torch.int32)
    return EventStream(addr=addr, valid=addr >= 0)


def events_per_position(s: torch.Tensor) -> torch.Tensor:
    """(..., P, C) -> (..., P) active-channel counts per spatial position
    ("spike events ... collected at the same spatial location", Alg. 1 l.9),
    int32."""
    return s.to(torch.int32).sum(dim=-1, dtype=torch.int32)


def word_event_counts(s: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Popcount per packed 32-channel word (Spike SRAM word granularity),
    int32; the packed axis must be a multiple of 32."""
    return popcount(pack_spikes(s, axis=axis))


def layer_sparsity_report(name: str, s: torch.Tensor) -> dict:
    """Instrumentation record used by the Fig. 2 / Fig. 7 benchmarks."""
    total = float(s.numel())
    active = float(s.float().sum())
    return {
        "layer": name,
        "total_sites": total,
        "events": active,
        "sparsity": 1.0 - active / max(total, 1.0),
    }


class EventTensor:
    """Binary spikes (or their words) + producer-emitted per-tile
    occupancy. `occupancy=None` is a valid degenerate state (metadata lost
    to a transform)."""

    __slots__ = ("spikes", "occupancy", "tiling", "chunks", "packed",
                 "feature_size", "spike_dtype", "_csr_cache")

    def __init__(self, spikes: Optional[torch.Tensor],
                 occupancy: Optional[torch.Tensor],
                 tiling: Tuple[int, int] = (128, 128),
                 chunks: Optional[torch.Tensor] = None,
                 packed: Optional[torch.Tensor] = None,
                 feature_size: Optional[int] = None,
                 spike_dtype: Optional[torch.dtype] = None):
        self.spikes = spikes
        self.occupancy = occupancy
        self.tiling = tuple(tiling)
        self.chunks = chunks
        self.packed = packed
        self._csr_cache = None
        if spikes is None and packed is None:
            raise ValueError("EventTensor needs a payload: spikes, packed, "
                             "or both")
        if spikes is not None:
            feature_size, spike_dtype = spikes.shape[-1], spikes.dtype
        elif feature_size is None:
            raise ValueError(
                "packed-only EventTensor needs feature_size= (the logical "
                "channel count; the word axis alone is ambiguous)")
        self.feature_size = int(feature_size)
        self.spike_dtype = spike_dtype or torch.float32
        if packed is not None:
            if packed.dtype != torch.uint32:
                raise ValueError(f"EventTensor packed payload must be uint32 "
                                 f"words, got {packed.dtype}")
            want_w = packed_width(self.feature_size)
            if packed.shape[-1] != want_w:
                raise ValueError(
                    f"EventTensor packed width {packed.shape[-1]} words "
                    f"does not cover feature_size {self.feature_size} "
                    f"(want {want_w})")
            if spikes is not None and \
                    tuple(packed.shape[:-1]) != tuple(spikes.shape[:-1]):
                raise ValueError(
                    f"EventTensor packed lead shape "
                    f"{tuple(packed.shape[:-1])} does not match spikes "
                    f"{tuple(spikes.shape[:-1])}")
        if occupancy is not None:
            want = self.expected_map_shape(*self.tiling)
            if tuple(occupancy.shape) != want:
                raise ValueError(
                    f"EventTensor occupancy shape {tuple(occupancy.shape)} "
                    f"does not cover spikes {tuple(self.shape)} under "
                    f"tiling {self.tiling} (expected {want})")
            if chunks is not None and tuple(chunks.shape) != (
                    want[0] * (self.tiling[0] // CHUNK), want[1]):
                raise ValueError(
                    f"EventTensor chunk map {tuple(chunks.shape)} does not "
                    f"refine occupancy {want} at {CHUNK}-row granularity")

    # ------------------------------------------------------- array facade
    @property
    def shape(self):
        if self.spikes is not None:
            return tuple(self.spikes.shape)
        return tuple(self.packed.shape[:-1]) + (self.feature_size,)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def is_packed(self) -> bool:
        """True when the words are the only payload (no dense spikes)."""
        return self.spikes is None

    @property
    def rows(self) -> int:
        return math.prod(self.shape[:-1])

    def expected_map_shape(self, tile_m: int, tile_k: int) -> Tuple[int, int]:
        k = self.shape[-1]
        return (-(-self.rows // tile_m), -(-k // tile_k))

    @classmethod
    def from_spikes(cls, spikes: torch.Tensor,
                    tiling: Tuple[int, int] = (128, 128),
                    pack: bool = False) -> "EventTensor":
        """Derive the maps from dense spikes (one chunk-granular dense
        pre-pass; the tile map is its 16:1 sum), for producers without
        fused emission. `pack=True` makes the uint32 words the only
        payload (a packed-only tensor, as `lif_fire_events(packed=True)`
        returns)."""
        tm, tk = tiling
        k = spikes.shape[-1]
        s2 = spikes.detach().reshape(-1, k)
        s2 = torch.nn.functional.pad(s2, (0, (-k) % tk,
                                          0, (-s2.shape[0]) % tm))
        chunks = tile_occupancy(s2, CHUNK, tk)
        occ = chunks.reshape(-1, tm // CHUNK, chunks.shape[1]).sum(
            dim=1, dtype=torch.int32)
        if pack:
            return cls(None, occ, tiling, chunks,
                       packed=pack_spikes_padded(spikes.detach()),
                       feature_size=k, spike_dtype=spikes.dtype)
        return cls(spikes, occ, tiling, chunks)

    def dense(self) -> torch.Tensor:
        """The dense spike view; for a packed-only tensor the one explicit
        unpack (words -> the logical channels in `spike_dtype`)."""
        if self.spikes is not None:
            return self.spikes
        return unpack_spikes_padded(self.packed, self.feature_size,
                                    self.spike_dtype)

    def occupancy_for(self, tile_m: int,
                      tile_k: int) -> Optional[torch.Tensor]:
        """The carried map, validated for a consumer tiling: None when no
        map is carried, ValueError when it was built for another tiling
        or tile grid."""
        if self.occupancy is None:
            return None
        if (tile_m, tile_k) != self.tiling:
            raise ValueError(
                f"EventTensor occupancy built for tiling {self.tiling} "
                f"used with tiling {(tile_m, tile_k)}")
        want = self.expected_map_shape(tile_m, tile_k)
        if tuple(self.occupancy.shape) != want:
            raise ValueError(
                f"EventTensor occupancy shape "
                f"{tuple(self.occupancy.shape)} does not match tile grid "
                f"{want} for spikes {self.shape}")
        return self.occupancy

    def csr(self, tile_m: int = 128, tile_k: int = 128):
        """Lazily build (and cache per instance) the `TileCSR` compaction
        of the carried map; None when no map is carried."""
        occ = self.occupancy_for(tile_m, tile_k)
        if occ is None:
            return None
        if self._csr_cache is None:
            self._csr_cache = build_csr(occ, tile_m, tile_k)
        return self._csr_cache

    def reshape(self, *shape) -> "EventTensor":
        """Reshape the payload; the carried maps survive iff the trailing
        axis is preserved (rows regroup, addresses don't move), else they
        are dropped. The words follow the same rule, and on a packed-only
        tensor a trailing-axis change raises instead of unpacking (call
        `.dense()` first)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = tuple(int(d) for d in shape)
        if -1 in shape:
            known = math.prod(d for d in shape if d != -1)
            shape = tuple(math.prod(self.shape) // max(known, 1)
                          if d == -1 else d for d in shape)
        k = self.shape[-1]
        keep = bool(shape) and shape[-1] == k
        if self.spikes is None and not keep:
            raise ValueError(
                f"reshape to {shape} changes the packed trailing axis "
                f"({k}); a packed-only EventTensor cannot re-bucket bits: "
                f"call .dense() (the explicit unpack) first")
        spikes = None if self.spikes is None else self.spikes.reshape(shape)
        packed = None
        if self.packed is not None and keep:
            packed = self.packed.reshape(shape[:-1] +
                                         (self.packed.shape[-1],))
        return EventTensor(spikes, self.occupancy if keep else None,
                           self.tiling, self.chunks if keep else None,
                           packed=packed, feature_size=k,
                           spike_dtype=self.spike_dtype)

    def astype(self, dtype: torch.dtype) -> "EventTensor":
        """Cast the dense view's dtype; on a packed-only tensor only the
        recorded unpack dtype changes (the words have none)."""
        spikes = None if self.spikes is None else self.spikes.to(dtype)
        return EventTensor(spikes, self.occupancy, self.tiling, self.chunks,
                           packed=self.packed,
                           feature_size=self.feature_size,
                           spike_dtype=dtype)


def as_spikes(x):
    """Dense view of a tensor-or-EventTensor operand (for a packed-only
    tensor, the explicit `.dense()` unpack: the densify point of the ops
    with no packed backend)."""
    return x.dense() if isinstance(x, EventTensor) else x


# ----------------------------------------------- occupancy propagation
def window_occupancy(et: EventTensor, window: Tuple[int, int], stride: int,
                     out_hw: Tuple[int, int], out_k: int,
                     padding: str = "SAME"):
    """Propagate a carried map through a raster-monotone spatial window
    transform (im2col patch extraction, pooling) without touching the
    spikes.

    `et.spikes` is (N, H, W, C)-shaped (lead axes folded into N); output
    position (n, y, x) reads the input window anchored at
    n*H*W + y*stride*W + x*stride. Each output chunk's bound is the sum of
    the input chunk counts its windows can reach: one cumsum over the
    small chunk map and two gathers. The reach is asymmetric (back by the
    leading SAME pad, forward by the rest of the window) and clamped to
    the owning image. Returns (tile map (MT_out, KT_out), chunk map
    (MT_out*16, KT_out)), both int32, or (None, None). The arithmetic
    stays on the map's device, so a CUDA map needs no host sync.
    """
    occ = et.occupancy_for(*et.tiling)
    if occ is None or et.ndim < 4:
        return None, None
    kh, kw = window
    h, w_, _ = et.shape[-3:]
    n = math.prod(et.shape[:-3])
    ho, wo = out_hw
    tm, tk = et.tiling
    per = tm // CHUNK
    out_rows = n * ho * wo
    mt_out = -(-out_rows // tm)
    kt_out = -(-out_k // tk)
    # Input counts at chunk granularity (a coarse-only carrier spreads each
    # tile's count over its 16 chunks: still conservative).
    if et.chunks is not None:
        cnt8 = et.chunks.sum(dim=1, dtype=torch.int64)
    else:
        cnt8 = occ.sum(dim=1, dtype=torch.int64).repeat_interleave(per)
    in_chunks = cnt8.shape[0]
    # XLA's SAME convention puts floor(pad/2) first; VALID pads nothing.
    if padding == "SAME":
        pad_top = max((ho - 1) * stride + kh - h, 0) // 2
        pad_left = max((wo - 1) * stride + kw - w_, 0) // 2
    else:
        pad_top = pad_left = 0
    back_halo = pad_top * w_ + pad_left
    fwd_halo = (kh - 1 - pad_top) * w_ + (kw - 1 - pad_left)
    out_chunks = mt_out * per
    ar = torch.arange(out_chunks, device=occ.device, dtype=torch.int64)
    q_lo = CHUNK * ar
    q_hi = torch.clamp(q_lo + CHUNK - 1, max=out_rows - 1)
    q_lo = torch.clamp(q_lo, max=out_rows - 1)   # zero-pad tail chunks below

    def reach(q, sign):
        n_i, rem = q // (ho * wo), q % (ho * wo)
        y, x = rem // wo, rem % wo
        a = n_i * (h * w_) + (y * stride) * w_ + x * stride
        if sign < 0:
            return torch.maximum(a - back_halo, n_i * (h * w_))
        return torch.minimum(a + fwd_halo, (n_i + 1) * (h * w_) - 1)

    csum = torch.cat([cnt8.new_zeros(1), torch.cumsum(cnt8, 0)])
    lo = torch.clamp(reach(q_lo, -1) // CHUNK, 0, in_chunks)
    hi = torch.clamp(reach(q_hi, +1) // CHUNK + 1, 0, in_chunks)
    live = (CHUNK * ar) < out_rows
    bound = ((csum[hi] - csum[lo]) * live).to(torch.int32)
    chunks_out = bound[:, None].expand(out_chunks, kt_out).contiguous()
    occ_out = chunks_out.reshape(mt_out, per, kt_out).sum(
        dim=1, dtype=torch.int32)
    return occ_out, chunks_out


def conv_patch_occupancy(et: EventTensor, w_shape: Tuple[int, ...],
                         stride: int,
                         padding: str) -> Optional[torch.Tensor]:
    """Carried map for the im2col patch matrix of a conv over `et`
    ((N,H,W,C) spikes, HWIO weights): rows = output positions, K =
    C*kh*kw. None when no map is carried or the geometry is unsupported."""
    if et.occupancy is None or et.ndim < 4 or padding not in ("SAME",
                                                              "VALID"):
        return None
    kh, kw, ci, _ = w_shape
    h, w_ = et.shape[-3:-1]
    out = (conv_pads(h, kh, stride, padding)[0],
           conv_pads(w_, kw, stride, padding)[0])
    if out[0] <= 0 or out[1] <= 0:
        return None
    occ, _ = window_occupancy(et, (kh, kw), stride, out, ci * kh * kw,
                              padding)
    return occ


def max_pool_events(et, pool: int):
    """Spatial max-pool (VALID) of (..., H, W, C) spikes with the carried
    maps propagated (chunk-granular window dilation) instead of dropped.
    Accepts a dense tensor too (returns a dense tensor). A packed-only
    tensor pools its words by bitwise OR (per bit, the OR of binary lanes
    is their max), so the payload stays packed.

    The gradient of each window goes whole to its FIRST maximum in
    row-major window order, as the VJP of `lax.reduce_window(max)`
    (select-and-scatter) sends it; `amax` would split it over ties, and
    binary spikes tie in almost every window."""
    packed = isinstance(et, EventTensor) and et.is_packed
    s = et.packed.view(torch.int32) if packed else as_spikes(et)
    h, w_, c = s.shape[-3:]
    ho, wo = h // pool, w_ // pool
    lead = s.ndim - 3
    win = s[..., :ho * pool, :wo * pool, :].reshape(
        s.shape[:-3] + (ho, pool, wo, pool, c))
    if packed:
        pooled = win[..., :, 0, :, 0, :]
        for dy in range(pool):
            for dx in range(pool):
                if dy or dx:
                    pooled = pooled | win[..., :, dy, :, dx, :]
        pooled = pooled.contiguous().view(torch.uint32)
        c = et.feature_size
    else:
        # (..., ho, wo, c, pool*pool): the window flattened row-major, so
        # argmax (the first maximal index) picks select-and-scatter's
        # element.
        flat = win.permute(*range(lead), lead, lead + 2, lead + 4, lead + 1,
                           lead + 3).reshape(s.shape[:-3] + (ho, wo, c, -1))
        pooled = flat.gather(-1, flat.argmax(dim=-1, keepdim=True)) \
            .squeeze(-1)
        if not isinstance(et, EventTensor):
            return pooled
    occ = chunks = None
    if et.occupancy is not None and et.ndim >= 4:
        occ, chunks = window_occupancy(et, (pool, pool), pool, (ho, wo), c,
                                       padding="VALID")
    if packed:
        return EventTensor(None, occ, et.tiling, chunks, packed=pooled,
                           feature_size=c, spike_dtype=et.spike_dtype)
    return EventTensor(pooled, occ, et.tiling, chunks)
