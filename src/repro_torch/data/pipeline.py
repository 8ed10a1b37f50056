"""Host-sharded, prefetching data pipeline, the port of
`repro.data.pipeline`.

Each host process generates only its shard of the global batch, on a
background thread that keeps up to `prefetch` batches ready, so step
N+1's host work overlaps step N's device work. The iterator state is a
single step counter: checkpoint-restore and elastic resharding (a
different shard count) resume exactly, because the generators are
(seed, shard, step)-deterministic.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


class ShardedPipeline:
    def __init__(self, make_batch: Callable[[int, int], dict],
                 n_shards: int, shard: int, start_step: int = 0,
                 prefetch: int = 2):
        """make_batch(shard, step) -> dict of numpy arrays (local shard)."""
        self._make = make_batch
        self.n_shards = n_shards
        self.shard = shard
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._make(self.shard, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self) -> "ShardedPipeline":
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def __iter__(self) -> Iterator[dict]:
        if self._thread is None:
            self.start()
        return self

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self.step = step + 1     # checkpointable position
        return batch

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    # ------------------------------------------------------ checkpointing
    def state_dict(self) -> dict:
        return {"step": self.step, "n_shards": self.n_shards,
                "shard": self.shard}

    @classmethod
    def restore(cls, make_batch, state: dict, *, n_shards: int | None = None,
                shard: int | None = None, prefetch: int = 2):
        """Resume; pass new n_shards/shard after an elastic reshard."""
        return cls(make_batch, n_shards or state["n_shards"],
                   shard if shard is not None else state["shard"],
                   start_step=state["step"], prefetch=prefetch)


def device_put_batch(batch: dict, device) -> dict:
    """Move a host batch to `device` (a `torch.device` or its name).
    Integer arrays (tokens, labels) become int64, the index type that
    embedding lookups and gathers take as they are; others keep their
    dtype."""
    def put(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        return t.to(device)
    return {k: put(v) for k, v in batch.items()}
