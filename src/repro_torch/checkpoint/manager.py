"""Rolling checkpoint manager: retention, auto-resume, corruption skip;
the port of `repro.checkpoint.manager`."""
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
                 save_every: int = 100, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.save_every = save_every
        self.async_save = async_save
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

    def save(self, step: int, tree: Any):
        self.wait()     # never overlap two saves
        # gc BEFORE launching the async write (must not race the new .tmp
        # dir); trim to keep-1 so the incoming checkpoint lands at `keep`.
        self._gc(reserve=1)
        self._pending = checkpointer.save(
            self.dir, step, tree, wait=not self.async_save)

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
    def restore_latest(self, target_tree: Any, device=None,
                       ) -> tuple[Optional[int], Any]:
        """Walk newest-first to the newest VALID snapshot; any corruption
        (a truncated, byte-flipped or vanished leaf, a mangled manifest:
        `checkpointer.CORRUPTION_ERRORS`) skips to an older checkpoint,
        logged, never fatal. The tree is fresh tensors on `device` (see
        `checkpointer.restore`); with no valid snapshot, (None,
        target_tree)."""
        for step in reversed(self.steps()):
            path = os.path.join(self.dir, f"step_{step:09d}")
            try:
                tree = checkpointer.restore(path, target_tree, device)
                return step, tree
            except checkpointer.CORRUPTION_ERRORS as e:  # corrupt -> older
                print(f"[ckpt] skipping step {step}: {e}")
        return None, target_tree
