"""Deterministic, seedable fault injectors for the guarded-execution layer.

Every injector returns a corrupted copy (never in-place: the event faults
are pure numpy over host copies, the rest copy the tensors they poison),
keyed by an integer seed, plus the injected coordinates where there are
any, so a test can assert the guard detected EXACTLY the fault it
planted. The same seeds give the reference's faults. The taxonomy mirrors
what the stack trusts:

  occupancy_undercount   carried map claims occupied tiles empty — the
                         event kernels would silently skip live work
  occupancy_overcount    map claims empty tiles occupied — LEGAL (maps
                         are upper bounds): wasted tile visits, not
                         wrong numerics; the audit must NOT flag it
  packed_bitflip         uint32 spike words gain set bits (0->1 only:
                         a 1->0 flip keeps the map a valid upper bound
                         and is invisible to bound checking — documented
                         detection asymmetry)
  stale_csr              TileCSR with wrong tiling / map-grid tags — the
                         consumers' `check_compatible` rejects it loudly
  nan_params             NaN'd parameter leaves (training/serve poison)
  nan_decode_state       NaN'd per-slot decode state (serve quarantine)
  truncated_checkpoint   a leaf file truncated mid-write (crashed/dropped
                         writer) — restore must detect and walk back
  dropped_shard          a data-shard group disappears mid-training —
                         recovered via `elastic.shrunk_mesh` +
                         `reshard_restore`, which wait for ROADMAP queue 1
                         item 8's sharded half (no injector here yet)

`FAULT_CLASSES` names the full set, in the reference's order. The first
three classes are detected by the guard (`kernels.dispatch.use_guard`),
`stale_csr` by `TileCSR.check_compatible`.
"""
from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.lm import _tree_map

# Detection home of each class.
FAULT_CLASSES = (
    "occupancy_undercount",    # kernels: guard audit/repair
    "occupancy_overcount",     # kernels: guard no-flag (upper bound)
    "packed_bitflip",          # kernels: guard audit/repair (popcount)
    "stale_csr",               # kernels: TileCSR.check_compatible
    "nan_params",              # serve: NaN/inf logit quarantine
    "nan_decode_state",        # serve: NaN/inf logit quarantine
    "truncated_checkpoint",    # checkpoint: CRC/size check + walk-back
    "dropped_shard",           # runtime: shrunk_mesh + reshard_restore
)

# Re-export: the guard's violation type lives with the policy.
from repro_torch.kernels.dispatch import GuardViolationError  # noqa: E402,F401


def _host(x) -> np.ndarray:
    """A numpy copy of a tensor (on any device) or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.uint32:      # words: reinterpret, never convert
            return x.view(torch.int32).numpy().view(np.uint32).copy()
        return x.numpy().copy()
    return np.array(x, copy=True)


# ------------------------------------------------------------- occupancy
def undercount_occupancy(occ, n_tiles: int = 1, seed: int = 0
                         ) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Zero `n_tiles` occupied entries of a carried map: the classic
    silent-drop fault (kernels skip tiles that hold live events).
    Returns (bad_map, [(mt, kt) coords zeroed])."""
    bad = _host(occ)
    occupied = np.argwhere(bad > 0)
    if occupied.shape[0] == 0:
        raise ValueError("map has no occupied tiles to undercount")
    rng = np.random.default_rng(seed)
    pick = rng.choice(occupied.shape[0],
                      size=min(n_tiles, occupied.shape[0]), replace=False)
    coords = [tuple(int(c) for c in occupied[i]) for i in pick]
    for c in coords:
        bad[c] = 0
    return bad, coords


def overcount_occupancy(occ, n_tiles: int = 1, seed: int = 0,
                        count: int = 7
                        ) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Claim `n_tiles` empty entries occupied (or inflate occupied counts
    when no tile is empty). LEGAL under the upper-bound contract: the
    guard must pass it and the numerics must be unchanged — this is the
    audit's false-positive control."""
    bad = _host(occ)
    empty = np.argwhere(bad == 0)
    rng = np.random.default_rng(seed)
    if empty.shape[0] == 0:
        coords = []
        bad += count                     # inflate: still an upper bound
    else:
        pick = rng.choice(empty.shape[0],
                          size=min(n_tiles, empty.shape[0]), replace=False)
        coords = [tuple(int(c) for c in empty[i]) for i in pick]
        for c in coords:
            bad[c] = count
    return bad, coords


# ---------------------------------------------------------------- packed
def flip_packed_bits(words, n_bits: int = 4, seed: int = 0
                     ) -> Tuple[np.ndarray, List[Tuple[int, ...]]]:
    """SET `n_bits` random zero bits of a uint32 word tensor (0->1 only).
    Sets create payload support the carried map never counted, which the
    guard's popcount audit detects; 1->0 clears keep the map a valid
    upper bound and are deliberately not injected (bound checking cannot
    see them — a paired exact-count map would be needed).
    Returns (corrupted_words, [(word_idx..., bit) flipped])."""
    w = _host(words)
    if w.dtype != np.uint32:
        raise ValueError(f"expected uint32 words, got {w.dtype}")
    bits = (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    zero_coords = np.argwhere(bits == 0)
    if zero_coords.shape[0] == 0:
        raise ValueError("no zero bits to flip")
    rng = np.random.default_rng(seed)
    pick = rng.choice(zero_coords.shape[0],
                      size=min(n_bits, zero_coords.shape[0]), replace=False)
    flipped = []
    for i in pick:
        *idx, bit = (int(c) for c in zero_coords[i])
        w[tuple(idx)] |= np.uint32(1) << np.uint32(bit)
        flipped.append(tuple(idx) + (bit,))
    return w, flipped


# ------------------------------------------------------------------- CSR
def stale_csr(csr, tiling: Optional[Tuple[int, int]] = (64, 64),
              map_shape: Optional[Tuple[int, int]] = None):
    """A TileCSR whose compatibility tags no longer match the call site
    (built for another tiling / another map grid). Consumers reject it
    via `TileCSR.check_compatible` — the loud path this injector pins."""
    kw = {}
    if tiling is not None:
        kw["tiling"] = tuple(tiling)
    if map_shape is not None:
        kw["map_shape"] = tuple(map_shape)
    return csr._replace(**kw)


# ------------------------------------------------------------- NaN poison
def _is_float_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _leaves(tree, out: list) -> None:
    """Tensor leaves of a dict / list / tuple / NamedTuple tree in the
    reference's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)


def nan_params(tree: Any, n_leaves: int = 1, seed: int = 0) -> Any:
    """NaN the first element of `n_leaves` float leaves, chosen by `seed`
    among the float leaves in tree order (the reference's choice)."""
    leaves: list = []
    _leaves(tree, leaves)
    float_ids = [id(x) for x in leaves if _is_float_leaf(x)]
    if not float_ids:
        raise ValueError("tree has no float leaves")
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(float_ids), size=min(n_leaves, len(float_ids)),
                      replace=False)
    chosen = {float_ids[p] for p in pick}

    def poison(x):
        if id(x) not in chosen:
            return x
        x = x.clone()
        x.view(-1)[0] = float("nan")
        return x
    return _tree_map(poison, tree)


def nan_decode_state(state: Any, slot: int, seed: int = 0) -> Any:
    """NaN one slot's decode state: every float leaf (stacked
    ``(n_groups, n_slots, ...)``, the slot on axis 1) gets NaN at `slot`,
    so that slot's next logits are non-finite."""
    del seed   # the slot is the caller's choice; the poison is total

    def poison(x):
        if not _is_float_leaf(x) or x.ndim < 2:
            return x
        hit = torch.zeros(x.shape[1], dtype=torch.bool, device=x.device)
        hit[slot] = True
        return torch.where(hit.reshape((1, -1) + (1,) * (x.ndim - 2)),
                           torch.full((), float("nan"), dtype=x.dtype,
                                      device=x.device), x)
    return _tree_map(poison, state)


# ------------------------------------------------------------ checkpoints
def _leaf_file(ckpt_dir: str, seed: int) -> str:
    """One leaf file of a checkpoint, chosen by `seed` (the reference's
    choice)."""
    leaf_files = sorted(f for f in os.listdir(ckpt_dir)
                        if f.startswith("leaf_") and f.endswith(".npy"))
    if not leaf_files:
        raise ValueError(f"no leaf files under {ckpt_dir}")
    rng = np.random.default_rng(seed)
    return os.path.join(ckpt_dir, leaf_files[int(rng.integers(
        len(leaf_files)))])


def truncate_checkpoint(ckpt_dir: str, keep_bytes: int = 64,
                        seed: int = 0) -> str:
    """Truncate one leaf file of a committed checkpoint to `keep_bytes`;
    the manifest still promises the full payload. Returns its path."""
    target = _leaf_file(ckpt_dir, seed)
    with open(target, "r+b") as f:
        f.truncate(keep_bytes)
    return target


def drop_checkpoint_file(ckpt_dir: str, seed: int = 0) -> str:
    """Delete one leaf file of a committed checkpoint. Returns its path."""
    target = _leaf_file(ckpt_dir, seed)
    os.remove(target)
    return target
