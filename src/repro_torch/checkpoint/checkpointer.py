"""Checkpointing: async save, checksummed, atomic; the port of
`repro.checkpoint.checkpointer`, on the same format.

Layout of one checkpoint:
    <dir>/step_000123/
        manifest.json      # step, per-leaf shape, dtype name, file
                           # bytes and CRC32
        leaf_00000.npy ... # one file per tree leaf
        _COMMITTED         # atomic commit marker (written last)

Leaves are numbered in `jax.tree_util.tree_flatten`'s order of the same
tree (dict keys sorted, a NamedTuple such as `AdamWState` in field order,
None an empty subtree), so a checkpoint written by either package
restores in the other. bfloat16 leaves are stored as their 16 bits
(`uint16`) with the logical name "bfloat16" in the manifest; numpy has
no bfloat16 of its own, and no third package is needed to read them.

Fault-tolerance contract:
  * save is crash-safe: a checkpoint without _COMMITTED is ignored and
    garbage-collected on the next save; every leaf and the manifest are
    fsynced before the marker, and the rename is made durable;
  * save copies every leaf to host memory before it returns, so an
    in-place update that follows (the port's AdamW writes params and
    moments in place) never reaches an async save;
  * every leaf carries a CRC32 checksum validated on restore, and every
    corruption surfaces as one of `CORRUPTION_ERRORS`;
  * restore builds fresh tensors on the device asked for: the result
    shares no storage with the target tree.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, List, Optional

import numpy as np
import torch

_COMMIT = "_COMMITTED"

# Everything a corrupt, truncated or vanished checkpoint can raise out of
# `restore` (short reads and bad checksums as IOError, a mangled header
# or manifest as ValueError / KeyError / EOFError); `restore_latest`
# catches this tuple and walks back to an older snapshot.
CORRUPTION_ERRORS = (OSError, ValueError, KeyError, EOFError)

BF16 = "bfloat16"


def _flatten(tree: Any) -> List[Any]:
    """Leaves in `jax.tree_util.tree_flatten` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(tree: Any, it) -> Any:
    """`tree`'s structure with its leaves taken from `it` in order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        built = {k: _unflatten(tree[k], it) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def _host(leaf: Any):
    """(numpy array to write, logical dtype name): a private host copy."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.array(leaf)
    return arr, arr.dtype.name


def _decode(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(directory: str, step: int, tree: Any = None,
         wait: bool = True, *, leaves=None) -> threading.Thread:
    """Write a checkpoint. wait=False returns once every leaf is copied to
    host memory, and writes on a thread (async save). `leaves` in place
    of `tree`: its leaves in `_flatten` order as an iterable, each copied
    to host memory as it comes (a leaf made for the save, such as a
    gathered expert bank, is then freed before the next is made)."""
    if leaves is None:
        leaves = _flatten(tree)
    host = [_host(leaf) for leaf in leaves]   # copy before async
    ckpt_dir = os.path.join(directory, f"step_{step:09d}")
    tmp_dir = ckpt_dir + ".tmp"

    def _write():
        os.makedirs(tmp_dir, exist_ok=True)
        manifest = {"step": step, "treedef": f"{len(host)} leaves in "
                    f"jax.tree_util.tree_flatten order", "leaves": []}
        for i, (arr, dtype_name) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            path = os.path.join(tmp_dir, fname)
            # fsync each leaf before the commit marker exists: a crash
            # between rename and writeback must never leave a COMMITTED
            # checkpoint with half-flushed payload bytes.
            with open(path, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"].append({
                "file": fname,
                "shape": list(arr.shape),
                "dtype": dtype_name,
                "nbytes": os.path.getsize(path),
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp_dir, _COMMIT), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        os.rename(tmp_dir, ckpt_dir)
        # Durable rename: fsync the parent directory entry too.
        try:
            dfd = os.open(directory, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    t = threading.Thread(target=_write, daemon=True)
    t.start()
    if wait:
        t.join()
    return t


def is_committed(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, _COMMIT))


def restore(ckpt_dir: str, target_tree: Any, device=None,
            cuts: Optional[list] = None) -> Any:
    """Load into the structure of `target_tree`: fresh tensors in the
    stored dtypes, on `device` (None: each target leaf's own device, the
    CPU for a non-tensor leaf). The target's leaves give shapes alone,
    so `meta` tensors will do. `cuts`: per leaf in `_flatten` order, a
    function applied to the whole leaf on the host before it moves to
    `device` (a rank's part of it), or None to keep it whole.

    Raises on checksum mismatch, truncation, or structural drift: every
    corruption mode surfaces as one of `CORRUPTION_ERRORS`, never a
    silently short or garbage tree.
    """
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _flatten(target_tree)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target has "
            f"{len(leaves)}: structure drift")
    out = []
    cuts = cuts if cuts is not None else [None] * len(leaves)
    for i, (meta, tgt, cut) in enumerate(zip(manifest["leaves"], leaves,
                                             cuts)):
        path = os.path.join(ckpt_dir, meta["file"])
        expected_bytes = meta.get("nbytes")
        if expected_bytes is not None \
                and os.path.getsize(path) != expected_bytes:
            raise IOError(
                f"leaf {i} is {os.path.getsize(path)} bytes, manifest "
                f"promises {expected_bytes}: truncated checkpoint")
        try:
            arr = np.load(path)
        except Exception as e:
            # np.load on a mangled file raises many types (EOFError,
            # ValueError, pickle errors...); one corruption surface.
            raise IOError(f"leaf {i} unreadable ({type(e).__name__}: {e}): "
                          f"corrupt checkpoint") from e
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
        if crc != meta["crc32"]:
            raise IOError(f"leaf {i} checksum mismatch: corrupt checkpoint")
        value = _decode(arr, meta["dtype"])
        if list(value.shape) != list(np.shape(tgt)):
            raise ValueError(
                f"leaf {i} shape {tuple(value.shape)} != target "
                f"{tuple(np.shape(tgt))}")
        if cut is not None:
            value = cut(value)
        dev = device if device is not None else (
            tgt.device if isinstance(tgt, torch.Tensor) else "cpu")
        out.append(value.to(dev))
    return _unflatten(target_tree, iter(out))
