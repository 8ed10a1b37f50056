"""Serving launcher: a continuous-batching scheduler over slot-based state.

A pool of batch slots shares one decode state (the SDSA statuses or KV
caches are per-slot along the batch axis). Requests arrive on a trace
clock, queue in, get assigned a free slot, are PREFILLED in one bucketed
chunked call (prefill/decode disaggregation: not streamed token at a
time through the pool's decode step), then decode at their OWN per-slot
position until their token budget, and release the slot.

The per-slot position vector is the load-bearing contract: the pool
steps with ``pos: (n_slots,)`` so a slot admitted while others are
mid-generation writes its KV rows / RoPE angles / causal mask at ITS
position, and decoding a request in a busy pool gives the tokens it
gives alone (tests/test_torch_serve.py pins this in both modes).

Per-slot SDSA state is O(d), so slot turnover costs no cache re-prefill
(`reset_slot_state` / `merge_slot_state` in models/lm.py are the
structural slot surgery). `ReplicaPool` layers multi-replica dispatch on
top, steering admission toward event-light replicas with
`runtime/straggler.occupancy_imbalance` as the load signal.

Every model call runs under `torch.inference_mode()` on the server's
device (the card by default). A raising prefill or decode step is
quarantined like a poisoned slot (bounded retries with backoff), so a
request that ends `failed` names its cause.

CLI: python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --requests 6 --max-new 16
     python -m repro_torch.launch.serve --arch tinyllama-1.1b --reduced \
        --device cpu --trace bursty --requests 24 --slots 8 --replicas 2
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.configs.base import LMConfig
from repro_torch.kernels import dispatch
from repro_torch.launch import steps as steps_mod
from repro_torch.models import lm
from repro_torch.runtime.straggler import (OccupancyImbalance,
                                           occupancy_imbalance)


class FakeClock:
    """Deterministic injectable clock for scheduler tests: ``clock()``
    reads, ``clock.advance(dt)`` moves time. `run_until_drained` advances
    an advanceable injected clock across backoff/arrival waits instead of
    real-sleeping (a real ``time.sleep`` under a fake clock spins the
    drain loop to its step cap without ever opening a gate)."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@dataclasses.dataclass
class Request:
    """One generation request with an explicit lifecycle.

    `state` walks pending -> running -> done|failed; every exit path
    (completion, deadline, prefill/decode fault, retry exhaustion)
    records a terminal state and releases the slot — a request is never
    silently lost. `failure_cause` keeps the LAST fault even when a
    retry later succeeds (observability of flaky slots); terminal
    failure iff ``state == "failed"``.
    """
    rid: int
    prompt: List[int]
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # --- guarded-execution fields ---
    deadline_s: Optional[float] = None   # wall-clock budget from submit()
    max_retries: int = 2                 # quarantine re-enqueue budget
    state: str = "pending"               # pending|running|done|failed
    failure_cause: Optional[str] = None  # last fault seen (terminal or not)
    retries: int = 0
    submitted_at: Optional[float] = None
    not_before: float = 0.0              # backoff gate (monotonic clock)
    # --- trace / latency fields ---
    arrival_s: Optional[float] = None    # trace arrival, relative to epoch
    finished_at: Optional[float] = None  # terminal timestamp (clock domain)


@dataclasses.dataclass(frozen=True)
class ReplicaLoad:
    """One replica's admission-time load: slot pressure plus event load.

    `event_occ` is the mean nonzero fraction of the busy slots' SDSA
    status vectors — accumulated spike traffic, the O(d)-cheap per-slot
    proxy for the occupied-tile counts the kernels will walk. Event skew
    is the load (NEURAL): two replicas with equal busy counts can carry
    very different event work, and `score` folds that in so admission
    steers toward the event-light replica."""
    busy: int
    queued: int
    event_occ: float

    @property
    def score(self) -> float:
        return self.busy + self.queued + self.event_occ * max(self.busy, 1)


class Server:
    """One model replica serving a pool of `n_slots` batch slots on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: LMConfig, n_slots: int = 4, max_seq: int = 256,
                 spiking: Optional[bool] = None, seed: int = 0, mesh=None,
                 clock=time.monotonic, backoff_s: float = 0.05,
                 prefill_bucket_min: int = 8, device="cuda"):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.spiking = cfg.spiking.enabled if spiking is None else spiking
        self.mesh = mesh
        self.device = resolve_device(device)
        # The decode step and the admission prefill resolve their kernels
        # under the mesh (per-shard gates on the slot batch, the axis a
        # deployment shards over `data`), so a degrade names itself. The
        # mesh steers RESOLUTION only, as in the reference: params and
        # slots stay on `device`. The step functions come first, so a
        # value that is not a mesh is refused before any weights are drawn.
        self._step = steps_mod.make_serve_step(cfg, self.spiking, mesh=mesh)
        # Bucketed chunked prefill (admission): prompts are padded to a
        # pow2 length bucket, pad steps masked out of the state.
        self._prefill = steps_mod.make_prefill_state(
            cfg, self.spiking, mesh=mesh, max_seq=max_seq)
        self.params = lm.init_params(cfg, seed=seed, device=self.device)
        self.state = lm.init_decode_state(cfg, n_slots, max_seq, self.spiking,
                                          device=self.device)
        self.pos = np.zeros(n_slots, np.int32)       # per-slot position
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.pending: List[Request] = []
        # the trace queue, by arrival_s
        self.arrivals: List[Request] = []
        self.epoch: Optional[float] = None           # t0 for arrival offsets
        self.finished: List[Request] = []            # done AND failed
        self._clock = clock                          # injectable for tests
        self.backoff_s = backoff_s                   # retry backoff base
        self.prefill_bucket_min = prefill_bucket_min
        self.steps_executed = 0
        self.prefills_executed = 0

    # --------------------------------------------------------- submission
    def submit(self, req: Request):
        if req.submitted_at is None:
            req.submitted_at = self._clock()
        req.state = "pending"
        self.pending.append(req)

    def submit_at(self, req: Request, arrival_s: float):
        """Queue `req` to arrive `arrival_s` seconds after the server's
        epoch (set at the first step) — the async-admission entry point
        for trace replay. The request is not visible to the scheduler (and
        its deadline clock does not start) until it arrives."""
        req.arrival_s = float(arrival_s)
        keys = [r.arrival_s for r in self.arrivals]
        self.arrivals.insert(bisect.bisect_right(keys, req.arrival_s), req)

    def _admit_arrivals(self, now: float):
        if self.epoch is None:
            self.epoch = now
        while self.arrivals \
                and self.epoch + self.arrivals[0].arrival_s <= now:
            self.submit(self.arrivals.pop(0))

    # ------------------------------------------------------ slot lifecycle
    def _reset_slot_state(self, i: int):
        """Zero slot i's decode state structurally (models/lm.py
        `reset_slot_state`: every leaf is (n_groups, n_slots, ...), slot
        batch = axis 1 — validated loudly, never shape-guessed). In
        spiking mode this is O(d) per layer (the SDSA status vectors);
        the dense KV cache pays its size."""
        self.state = lm.reset_slot_state(self.state, i, self.n_slots)
        self.pos[i] = 0

    def _finish(self, i: int, req: Request, state: str,
                cause: Optional[str] = None):
        """Terminal exit: record the outcome and release the slot."""
        req.state = state
        req.done = state == "done"
        req.finished_at = self._clock()
        if cause is not None:
            req.failure_cause = cause
        self.finished.append(req)
        if i >= 0:
            self.slot_req[i] = None
            self.pos[i] = 0

    def _quarantine(self, i: int, cause: str):
        """Non-terminal fault on slot i: reset the slot, re-enqueue the
        request with bounded retries + exponential backoff, or fail it
        terminally when the retry budget is spent. Partial output is
        discarded — a retried request regenerates from its prompt."""
        req = self.slot_req[i]
        self.slot_req[i] = None
        self._reset_slot_state(i)
        if req is None:
            return
        req.failure_cause = cause
        if req.retries >= req.max_retries:
            self._finish(-1, req, "failed", cause)
            return
        req.retries += 1
        req.generated = []
        req.state = "pending"
        req.not_before = self._clock() \
            + self.backoff_s * (2 ** (req.retries - 1))
        self.pending.append(req)

    def _expire_deadlines(self, now: float):
        """Deadline is terminal on every path: active slots are released,
        queued requests never admitted. A request that reached the
        scheduler without going through submit() (direct pending append,
        replica handoff) is stamped here at first observation — the
        deadline clock never dereferences a missing timestamp."""
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            if req.submitted_at is None:
                req.submitted_at = now
            if req.deadline_s is not None \
                    and now - req.submitted_at > req.deadline_s:
                self._finish(i, req, "failed", "deadline")
        kept = []
        for req in self.pending:
            if req.submitted_at is None:
                req.submitted_at = now
            if req.deadline_s is not None \
                    and now - req.submitted_at > req.deadline_s:
                self._finish(-1, req, "failed", "deadline")
            else:
                kept.append(req)
        self.pending = kept

    # ---------------------------------------------------------- admission
    def _bucket(self, n: int) -> int:
        b = self.prefill_bucket_min
        while b < n:
            b *= 2
        return b

    def _admit(self, i: int, req: Request):
        """Assign slot i and chunk-prefill the prompt in one bucketed
        call: the fresh single-request state is scattered into the pool
        (merge overwrites EVERY leaf of the slot — admission never
        inherits a previous occupant's KV rows or SDSA status) and the
        slot's position starts at len(prompt). The first generated token
        comes from the prefill's last-position logits."""
        req.state = "running"
        self.slot_req[i] = req
        prompt = list(req.prompt) if req.prompt else [0]
        n = len(prompt)
        toks = np.zeros((1, self._bucket(n)), np.int64)
        toks[0, :n] = prompt
        try:
            logits, single = self._prefill(
                self.params, torch.from_numpy(toks).to(self.device),
                torch.tensor([n], device=self.device))
            logits_np = logits[0].cpu().numpy()
        except Exception as e:
            self._quarantine(i, f"prefill_error:{type(e).__name__}")
            return
        if not np.isfinite(logits_np).all():
            self._quarantine(i, "nan_logits")
            return
        self.state = lm.merge_slot_state(self.state, single, i)
        self.pos[i] = n
        self.prefills_executed += 1
        req.generated.append(int(logits_np.argmax()))
        self._maybe_complete(i, req)

    def _maybe_complete(self, i: int, req: Request):
        if len(req.generated) >= req.max_new \
                or self.pos[i] >= self.max_seq - 1:
            self._finish(i, req, "done")

    def _assign_slots(self, now: float):
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        kept, admitted = [], []
        for req in self.pending:
            if len(req.prompt) >= self.max_seq:
                self._finish(-1, req, "failed", "prompt_too_long")
            elif free and req.not_before <= now:
                admitted.append((free.pop(0), req))
            else:
                kept.append(req)
        self.pending = kept
        for i, req in admitted:
            self._admit(i, req)

    # --------------------------------------------------------- load signal
    def occupancy_load(self) -> ReplicaLoad:
        """Admission-time load: busy slots, queue depth, and the event
        occupancy of the busy slots' SDSA statuses (spiking mode; 0.0
        dense — a dense replica's event load is its slot count)."""
        busy = [i for i, r in enumerate(self.slot_req) if r is not None]
        ev = 0.0
        if busy and self.spiking:
            nz = tot = 0
            for layer in self.state:
                if layer.sdsa is None:
                    continue
                status = layer.sdsa.status[:, busy]
                nz += int(torch.count_nonzero(status))
                tot += status.numel()
            if tot:
                ev = nz / tot
        return ReplicaLoad(busy=len(busy),
                           queued=len(self.pending) + len(self.arrivals),
                           event_occ=ev)

    # -------------------------------------------------------------- stepping
    @torch.inference_mode()
    def step(self):
        """One batched decode step across all active slots, at their
        per-slot positions. Every fault has an exit path: a raising
        prefill/decode quarantines (bounded retries), non-finite logits
        quarantine their slot, and deadline overruns fail terminally —
        no slot leaks, no request is dropped without a recorded cause."""
        now = self._clock()
        self._admit_arrivals(now)
        self._expire_deadlines(now)
        self._assign_slots(now)
        tokens = np.zeros(self.n_slots, np.int64)
        active = np.zeros(self.n_slots, bool)
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            active[i] = True
            tokens[i] = req.generated[-1] if req.generated \
                else (req.prompt[-1] if req.prompt else 0)
        if not active.any():
            return False
        # per-slot positions (n_slots,)
        pos = torch.from_numpy(self.pos.astype(np.int64)).to(self.device)
        try:
            logits, new_state = self._step(
                self.params, self.state,
                torch.from_numpy(tokens).to(self.device), pos)
            logits_np = logits.cpu().numpy()
        except Exception as e:   # decode fault: the batch can't attribute
            # a raising step to one slot, so every active slot quarantines
            # (healthy requests spend one retry and regenerate).
            for i, req in enumerate(self.slot_req):
                if req is not None:
                    self._quarantine(i, f"decode_error:{type(e).__name__}")
            return True
        self.state = new_state
        self.steps_executed += 1
        finite = np.isfinite(logits_np).all(axis=-1)
        next_tokens = np.argmax(logits_np, axis=-1)
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            if not finite[i]:
                # NaN/inf logits: poisoned slot state or params. Reset
                # the slot and re-enqueue — never emit a poisoned token.
                self._quarantine(i, "nan_logits")
                continue
            self.pos[i] += 1
            req.generated.append(int(next_tokens[i]))
            self._maybe_complete(i, req)
        return True

    # ------------------------------------------------------------- draining
    def _next_gate(self, now: float) -> Optional[float]:
        """Earliest future instant anything becomes actionable: a backoff
        gate opening or a trace arrival. None when nothing is queued."""
        gates = [r.not_before for r in self.pending]
        if self.arrivals:
            gates.append((self.epoch if self.epoch is not None else now)
                         + self.arrivals[0].arrival_s)
        return min(gates) if gates else None

    def _idle_wait(self):
        """Nothing active but work queued: wait for the next gate. An
        advanceable injected clock (FakeClock) is advanced directly —
        deterministic tests never real-sleep; the real clock sleeps in
        small increments."""
        now = self._clock()
        gate = self._next_gate(now)
        delay = max((gate - now) if gate is not None else 0.0, 1e-4)
        advance = getattr(self._clock, "advance", None)
        if advance is not None:
            advance(delay)
        elif self._clock is time.monotonic:
            time.sleep(min(delay, 0.005))
        # else: a bare injected callable can't be advanced — do NOT
        # real-sleep against fake time; the drain loop spends a step.

    def run_until_drained(self, max_steps: int = 10_000):
        """Drive until no request is active, pending, or still arriving
        (or `max_steps`). Returns the finished requests — done and
        terminally failed."""
        for _ in range(max_steps):
            stepped = self.step()
            if not stepped:
                if not self.pending and not self.arrivals:
                    break
                self._idle_wait()
        return self.finished


class ReplicaPool:
    """Multi-replica dispatch: N Servers over one model, admission
    steered by the occupancy-imbalance load signal.

    Each arriving request is routed to the replica with the lowest
    `ReplicaLoad.score` (busy slots + queue depth + event occupancy of
    the busy slots — event skew is the load, so two equally-busy
    replicas are told apart by the spike traffic their slots carry).
    Every routing decision records a
    `runtime.straggler.occupancy_imbalance` over the per-replica scores
    in `imbalance_log` — the same max/mean skew signal the sharded
    training path monitors, here driving admission instead of
    rebalancing. ``balancer="round_robin"`` is the load-blind baseline.
    """

    def __init__(self, cfg: LMConfig, n_replicas: int = 2,
                 balancer: str = "occupancy", clock=time.monotonic,
                 **server_kw):
        if balancer not in ("occupancy", "round_robin"):
            raise ValueError(f"unknown balancer {balancer!r}")
        # Same seed per replica: true replicas of one model.
        self.replicas = [Server(cfg, clock=clock, **server_kw)
                         for _ in range(n_replicas)]
        self.balancer = balancer
        self._clock = clock
        self._rr = 0
        self.arrivals: List[Request] = []
        self.epoch: Optional[float] = None
        self.imbalance_log: List[OccupancyImbalance] = []

    def _dispatch(self, req: Request):
        loads = [r.occupancy_load() for r in self.replicas]
        # Integer-scaled scores feed the same skew summary the training
        # straggler monitor uses; imbalance 1.0 = perfectly balanced.
        self.imbalance_log.append(occupancy_imbalance(
            [int(round(100 * ld.score)) for ld in loads]))
        if self.balancer == "round_robin":
            idx = self._rr
            self._rr = (self._rr + 1) % len(self.replicas)
        else:
            idx = min(range(len(loads)), key=lambda j: loads[j].score)
        self.replicas[idx].submit(req)
        return idx

    def submit(self, req: Request):
        return self._dispatch(req)

    def submit_at(self, req: Request, arrival_s: float):
        """Route at ARRIVAL, not submission — load is only current when
        the request actually shows up."""
        req.arrival_s = float(arrival_s)
        keys = [r.arrival_s for r in self.arrivals]
        self.arrivals.insert(bisect.bisect_right(keys, req.arrival_s), req)

    def step(self) -> bool:
        now = self._clock()
        if self.epoch is None:
            self.epoch = now
        while self.arrivals and self.epoch + self.arrivals[0].arrival_s <= now:
            self._dispatch(self.arrivals.pop(0))
        stepped = [r.step() for r in self.replicas]
        return any(stepped)

    @property
    def finished(self) -> List[Request]:
        return [req for r in self.replicas for req in r.finished]

    def _idle_wait(self):
        now = self._clock()
        gates = [g for g in (r._next_gate(now) for r in self.replicas)
                 if g is not None]
        if self.arrivals:
            gates.append((self.epoch if self.epoch is not None else now)
                         + self.arrivals[0].arrival_s)
        delay = max((min(gates) - now) if gates else 0.0, 1e-4)
        advance = getattr(self._clock, "advance", None)
        if advance is not None:
            advance(delay)
        elif self._clock is time.monotonic:
            time.sleep(min(delay, 0.005))

    def run_until_drained(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            stepped = self.step()
            if not stepped:
                if not self.arrivals and not any(
                        r.pending or r.arrivals for r in self.replicas):
                    break
                self._idle_wait()
        return self.finished


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--replicas", type=int, default=1,
                    help="multi-replica dispatch: >1 runs a ReplicaPool "
                         "with occupancy-steered admission")
    ap.add_argument("--trace", default=None,
                    choices=("poisson", "bursty"),
                    help="replay a synthetic arrival trace "
                         "(benchmarks/serve_traces.py) instead of "
                         "submitting everything at t=0")
    ap.add_argument("--backend", default=None,
                    help="kernel backend override, same grammar as "
                         "EXSPIKE_BACKEND (e.g. 'ref' or 'lif_scan=cuda,ref')")
    ap.add_argument("--mesh", action="store_true",
                    help="resolve kernel dispatch mesh-aware against the "
                         "host mesh (per-shard gates, degrade attribution "
                         "printed below); params and slots stay on the "
                         "device")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card; "
                         "'cpu' runs the plain PyTorch versions)")
    args = ap.parse_args()
    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    if args.backend:
        os.environ[dispatch.ENV_VAR] = args.backend
    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(device=device)
    print(f"[serve] kernel backends"
          f"{' (mesh-aware)' if mesh is not None else ''} on {device}: "
          f"{dispatch.resolved_backends(device, mesh=mesh)}")
    kw = dict(n_slots=args.slots,
              spiking=False if args.dense else None, device=device,
              mesh=mesh)
    server = (ReplicaPool(cfg, n_replicas=args.replicas, **kw)
              if args.replicas > 1 else Server(cfg, **kw))
    rng = np.random.default_rng(0)
    if args.trace:
        from benchmarks.serve_traces import make_trace
        trace = make_trace(args.trace, seed=0, n_requests=args.requests,
                           vocab=cfg.vocab, max_new=(args.max_new,
                                                     args.max_new))
        reqs = []
        for t in trace:
            r = Request(rid=t.rid, prompt=list(t.prompt), max_new=t.max_new)
            server.submit_at(r, t.arrival_s)
            reqs.append(r)
    else:
        reqs = [Request(rid=i,
                        prompt=[int(t) for t in rng.integers(0, cfg.vocab, 8)],
                        max_new=args.max_new)
                for i in range(args.requests)]
        for r in reqs:
            server.submit(r)
    t0 = time.time()
    server.run_until_drained()
    dt = time.time() - t0
    total_new = sum(len(r.generated) for r in reqs)
    servers = server.replicas if isinstance(server, ReplicaPool) \
        else [server]
    steps = sum(s.steps_executed for s in servers)
    prefills = sum(s.prefills_executed for s in servers)
    print(f"[serve] {len(reqs)} requests, {total_new} tokens, "
          f"{steps} decode steps + {prefills} prefills, {dt:.1f}s "
          f"({total_new / dt:.1f} tok/s)")
    if isinstance(server, ReplicaPool) and server.imbalance_log:
        last = server.imbalance_log[-1]
        print(f"[serve] admission load signal: {last.as_fields()}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt {r.prompt[:4]}... -> "
              f"{r.generated[:8]}...")


if __name__ == "__main__":
    main()
