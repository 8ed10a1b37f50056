"""Straggler detection & mitigation for the synchronous training loop.

At pod scale, a slow host stalls every synchronous collective. The monitor
tracks per-step wall times with an EMA, flags steps beyond
`threshold x EMA`, and drives two mitigations the launcher implements:

  * data-shard reassignment — a persistently slow host's input shard is
    regenerated by its backup (the (seed, shard, step)-deterministic
    pipeline makes this free of coordination beyond the shard index);
  * step-skip voting — if the same host flags `patience` consecutive
    steps, the launcher checkpoints and excludes it at the next elastic
    restart (`runtime.elastic`).

A stdlib-only copy of `repro.runtime.straggler`: the serve scheduler's
replica dispatch and `runtime.sharding.event_op_sharded`'s report read
`occupancy_imbalance`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class StragglerConfig:
    ema_decay: float = 0.9
    threshold: float = 2.0       # flag if step > threshold * EMA
    patience: int = 5            # consecutive flags before exclusion vote
    warmup_steps: int = 3        # ignore compile/first steps
    occupancy_threshold: float = 1.5   # flag max/mean occupied-tile skew


@dataclasses.dataclass(frozen=True)
class OccupancyImbalance:
    """Per-shard event-load skew for the synchronous event-driven path.

    Irregular sparsity is exactly what makes event shards straggle: the
    compacted (CSR) grid sizes each shard's work by its OWN occupied-tile
    count, so under a synchronous collective every shard waits for the
    most occupied one. `imbalance` = max/mean occupied tiles per shard —
    1.0 is perfectly balanced; the (imbalance - 1) excess is wall-clock
    the under-occupied shards spend idle. Wall-time EMAs (above) catch
    slow *hosts*; this catches slow *data*, which moves every step as the
    event distribution shifts, and is the signal an elastic scheduler
    would rebalance shards on (NEURAL-style occupancy-dependent degrade).
    """
    per_shard: tuple              # occupied tiles per shard, shard order
    max_occupied: int
    mean_occupied: float
    imbalance: float              # max / mean (1.0 when all empty)
    worst_shard: int
    # Per-shard hybrid route choices ("event"/"dense", shard order), when
    # density-adaptive dispatch routed this op: occupancy skew is not only
    # a wait-time signal — under hybrid execution it is a *routing* split,
    # and a sparse shard legitimately running the event kernel while a
    # dense shard runs predicated IS the feature, recorded here.
    routes: tuple = ()
    # Occupied-tile counts under the STATIC row-contiguous split, set only
    # when occupancy-weighted shard rebalancing ran (then `per_shard` is
    # the post-rebalance assignment): the before/after pair is what the
    # CSV ledger shows rebalancing bought this step.
    pre_per_shard: tuple = ()
    pre_imbalance: Optional[float] = None

    def as_fields(self) -> str:
        """CSV `derived`-column fragment (benchmarks / logs)."""
        per = ":".join(str(int(x)) for x in self.per_shard)
        out = (f"occ_per_shard={per};occ_max={self.max_occupied};"
               f"occ_mean={self.mean_occupied:.2f};"
               f"occ_imbalance={self.imbalance:.3f}")
        if self.pre_per_shard:
            pre = ":".join(str(int(x)) for x in self.pre_per_shard)
            out += (f";occ_pre_per_shard={pre};"
                    f"occ_pre_imbalance={self.pre_imbalance:.3f}")
        if self.routes:
            out += ";occ_routes=" + ":".join(self.routes)
        return out


def occupancy_imbalance(per_shard_occupied, routes=(),
                        pre_per_shard=None) -> OccupancyImbalance:
    """Summarize per-shard occupied-tile counts into the straggler signal.
    `routes`: optional per-shard hybrid route choices (same order).
    `pre_per_shard`: optional counts under the static split when
    `per_shard_occupied` is a rebalanced assignment — the pre-rebalance
    column of the before/after pair.

    Doubles as the serve-admission load signal: `launch/serve.ReplicaPool`
    feeds per-replica load scores (busy slots + queue + SDSA event
    occupancy, integer-scaled) through this same summary on every routing
    decision — event skew is the load there too."""
    per = tuple(int(x) for x in per_shard_occupied)
    if not per:
        raise ValueError("no shards")
    mx = max(per)
    mean = sum(per) / len(per)
    pre = tuple(int(x) for x in pre_per_shard) if pre_per_shard else ()
    pre_imb = None
    if pre:
        pre_mean = sum(pre) / len(pre)
        pre_imb = (max(pre) / pre_mean) if pre_mean > 0 else 1.0
    return OccupancyImbalance(
        per_shard=per, max_occupied=mx, mean_occupied=mean,
        imbalance=(mx / mean) if mean > 0 else 1.0,
        worst_shard=per.index(mx), routes=tuple(routes),
        pre_per_shard=pre, pre_imbalance=pre_imb)


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.ema: Optional[float] = None
        self.steps = 0
        self.consecutive_flags = 0
        self.flagged_steps: list[int] = []
        self._t0: Optional[float] = None
        self._occupancy: Optional[OccupancyImbalance] = None

    def note_occupancy(self, imb: OccupancyImbalance) -> None:
        """Attach the current step's per-shard event-load report; it rides
        along in the next `step_end` dict (with its own flag) so launchers
        can tell data-skew straggling apart from slow-host straggling."""
        self._occupancy = imb

    def step_start(self):
        self._t0 = time.perf_counter()

    def step_end(self) -> dict:
        assert self._t0 is not None, "step_start() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.steps += 1
        report = {"step": self.steps, "seconds": dt, "flagged": False,
                  "exclude_vote": False}
        if self._occupancy is not None:
            report["occupancy"] = self._occupancy
            report["occupancy_flagged"] = \
                self._occupancy.imbalance > self.cfg.occupancy_threshold
            self._occupancy = None
        if self.steps <= self.cfg.warmup_steps:
            return report
        if self.ema is None:
            self.ema = dt
            return report
        if dt > self.cfg.threshold * self.ema:
            self.consecutive_flags += 1
            self.flagged_steps.append(self.steps)
            report["flagged"] = True
            report["exclude_vote"] = \
                self.consecutive_flags >= self.cfg.patience
        else:
            self.consecutive_flags = 0
            self.ema = (self.cfg.ema_decay * self.ema
                        + (1 - self.cfg.ema_decay) * dt)
        report["ema"] = self.ema
        return report
