"""Rolling checkpoint manager: retention, auto-resume, corruption skip;
the port of `repro.checkpoint.manager`.

Across the ranks of a process group one rank writes (`writer=True` on
rank 0 alone; the others' `save` does nothing) and every rank reads:
`restore_latest(group=)` has the ranks agree on one step, walking back
past a snapshot that any of them cannot read."""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, List, Optional

from . import checkpointer

_STEP_RE = re.compile(r"^step_(\d{9})$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 save_every: int = 100, async_save: bool = True,
                 writer: bool = True):
        self.dir = directory
        self.keep = keep
        self.save_every = save_every
        self.async_save = async_save
        self.writer = writer
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------- discovery
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and checkpointer.is_committed(os.path.join(self.dir, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # --------------------------------------------------------------- save
    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, tree: Any = None, *, leaves=None):
        """Save `tree`, or the iterable `leaves` of one in checkpoint
        order (`checkpointer.save`). A rank that does not write still
        walks `leaves` to its end: every rank takes part in the gather
        that makes each leaf (`runtime.sharding.full_leaves`)."""
        if not self.writer:
            for _ in leaves or ():
                pass
            return
        self.wait()     # never overlap two saves
        # gc BEFORE launching the async write (must not race the new .tmp
        # dir); trim to keep-1 so the incoming checkpoint lands at `keep`.
        self._gc(reserve=1)
        self._pending = checkpointer.save(
            self.dir, step, tree, wait=not self.async_save, leaves=leaves)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self, reserve: int = 0):
        # Remove uncommitted temp dirs and old checkpoints beyond retention.
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if name.endswith(".tmp"):
                shutil.rmtree(full, ignore_errors=True)
        steps = self.steps()
        limit = max(1, self.keep - reserve)
        for s in steps[: max(0, len(steps) - limit)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------ restore
    def _restore(self, step: int, target_tree: Any, device, cuts=None):
        """The tree of `step`, or None where it is corrupt (logged)."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        try:
            return checkpointer.restore(path, target_tree, device, cuts)
        except checkpointer.CORRUPTION_ERRORS as e:   # corrupt -> older
            print(f"[ckpt] skipping step {step}: {e}")
            return None

    def restore_latest(self, target_tree: Any, device=None, *, group=None,
                       cuts: Optional[list] = None,
                       ) -> tuple[Optional[int], Any]:
        """Walk newest-first to the newest VALID snapshot; any corruption
        (a truncated, byte-flipped or vanished leaf, a mangled manifest:
        `checkpointer.CORRUPTION_ERRORS`) skips to an older checkpoint,
        logged, never fatal. The tree is fresh tensors on `device` (see
        `checkpointer.restore`); with no valid snapshot, (None,
        target_tree). `cuts`: per leaf, what of it to keep
        (`checkpointer.restore`).

        `group` (a process group, or `torch.distributed.group.WORLD`):
        every rank of it calls this, and all take the same step: the
        oldest of the ranks' newest valid snapshots, walking back further
        while any rank cannot read the agreed one."""
        if group is None:
            for step in reversed(self.steps()):
                tree = self._restore(step, target_tree, device, cuts)
                if tree is not None:
                    return step, tree
            return None, target_tree
        from repro_torch.launch import distributed
        import torch.distributed as dist
        below = None
        while True:
            step, tree = None, None
            for s in reversed(self.steps()):
                if below is not None and s >= below:
                    continue
                tree = self._restore(s, target_tree, device, cuts)
                if tree is not None:
                    step = s
                    break
            agreed = distributed.reduce_int(
                -1 if step is None else step, group, dist.ReduceOp.MIN)
            if agreed < 0:
                return None, target_tree
            if agreed != step:
                tree = self._restore(agreed, target_tree, device, cuts)
            ok = distributed.reduce_int(int(tree is not None), group,
                                        dist.ReduceOp.MIN)
            if ok:
                return agreed, tree
            below = agreed
