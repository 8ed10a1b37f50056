"""Deterministic fault injectors for the serve loop's quarantine.

Each injector returns a corrupted copy (the input is never written), so a
test can assert the scheduler detected exactly the fault it planted:

  nan_params         NaN'd parameter leaves (a poisoned optimizer step or
                     a corrupt weight load); serve's logit quarantine is
                     the detector
  nan_decode_state   NaN'd per-slot decode state; the next decode step's
                     logits for that slot are non-finite and the slot is
                     quarantined

The checkpoint faults write the files of a committed checkpoint, as the
reference's do:

  truncate_checkpoint    a leaf file cut short (a writer that died
                         mid-flush); restore must detect it and
                         `restore_latest` walk back
  drop_checkpoint_file   a leaf file gone (a lost shard)

The rest of the reference's taxonomy waits for ROADMAP queue 1 item 8:
`FAULT_CLASSES`, the occupancy under- and overcount, packed bit-flip and
stale-CSR faults, and `GuardViolationError`.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.models.lm import _tree_map


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
