"""Occupancy-skipping spike matmuls on the 128x128 tile grid of s.

`spike_matmul_csr(s, w, csr)` is event-compacted: it sums only the
occupied (m-tile, k-tile) steps of `csr` (a `core.spikes.TileCSR`) and
launches `csrc/spike_matmul_csr.cu`, an event walk (one weight-row add
per nonzero spike, csrc/event_walk.cuh) whose sums
`spike_matmul_csr_chain_plain` repeats bit for bit (a k-order fmaf
chain). `spike_matmul_pred(s, w, occ)` is predicated: every m-tile row
walks all its k-tiles and the map gates each product; it launches
`csrc/spike_matmul.cu`, which streams the live k-tiles of a row through
a copy ring of its own for N <= 16, and for N > 16 through a ring of TMA
box copies fed by a producer warp (`tma_ring_programs` / `run_tma_ring`
are its CPU twin), or the CSR kernels' cp.async ring where TMA cannot
describe an operand (`pred_launch` says which).
`spike_matmul_csr_pipe(s, w, csr)` is the same function, with the same
sums, on the pipelined kernel
`csrc/spike_matmul_csr_pipe.cu` (a cp.async ring of 32-deep k-slices);
its plain version walks the ring's schedule (`ring_schedule`) and checks
it (`check_ring_trace`). `apec_matmul_csr(res, ov, w, g, csr, occ_res,
occ_ov)` is APEC's fused pair of products over a union work list; it
launches `csrc/apec_matmul_csr.cu`, the same event walk over both
operands, whose sums `apec_matmul_csr_chain_plain` repeats bit for bit,
and `apec_matmul_csr_pipe` the same function on the ring
(`csrc/apec_matmul_csr_pipe.cu`, the schedule's union-gated twin checked
in its plain version). `spike_matmul_packed_csr`,
`spike_matmul_packed_csr_pipe`, `apec_matmul_packed_csr` and
`apec_matmul_packed_csr_pipe` are the same kernels with the spike
operands as uint32 words ((M, ceil(K/32)), bit i of word w = column
32w+i), each word tile read on chip. On a CPU tensor each runs its plain
version (the packed ones unpack, then run the f32 plain version). All
accept any (M, K) x (K, N): ragged edge tiles are masked, never padded.
`spike_matmul_pred`, `spike_matmul_csr` and `apec_matmul_csr` (rows 10,
11 and 17) also launch gated: with `route` (a one-element int32 tensor
on the card) and `out`, every block returns at entry unless the int is
nonzero, so hybrid dispatch launches both routes of a call behind one
flag computed on the card (`ops.hybrid_route`) and only the chosen one
writes `out`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.spikes import (TileCSR, packed_width,
                                     unpack_spikes_padded)
from . import _build

TILE = 128     # map / work-list tiling (rows and k)
PIPE_SLICE = 32    # k depth of a ring stage (csrc/tile_mma.cuh: kSlice)
PIPE_STAGES = 3    # ring depth (csrc/tile_mma.cuh: kStages)
# The APEC kernels' ring depth (csrc/apec_matmul_csr_pipe.cu: kApecStages).
APEC_PIPE_STAGES = 4
# Kernel 10's TMA ring depth (csrc/spike_matmul.cu: kWideStages).
WIDE_STAGES = 4


def csr_tile_gate(csr: TileCSR, mt: int, kt: int,
                  occ: torch.Tensor | None = None) -> torch.Tensor:
    """(MT, KT) bool: True where the work list has an occupied step. Walks
    each row's steps row_ptr[r]:row_ptr[r+1], as the kernel does; dummy
    steps (occ 0) and padding steps past row_ptr[MT] gate nothing. `occ`:
    per-step counts to gate on instead of `csr.occ` (one operand's counts
    on a union work list)."""
    occ = csr.occ if occ is None else occ
    steps = torch.arange(csr.n_steps, device=csr.row_ptr.device)
    row = torch.searchsorted(csr.row_ptr[1:].long(), steps, right=True)
    live = (steps < csr.row_ptr[-1]) & (occ > 0)
    gate = torch.zeros(mt * kt, dtype=torch.int32, device=steps.device)
    flat = row.clamp(max=mt - 1) * kt + csr.tile_k_idx.long()
    gate.index_put_((flat,), live.to(torch.int32), accumulate=True)
    return gate.reshape(mt, kt) > 0


def _gated(s: torch.Tensor, gate: torch.Tensor,
           tile_m: int = TILE) -> torch.Tensor:
    """s with the (tile_m, 128) tiles whose gate is 0 (or False) zeroed."""
    m, k = s.shape
    mask = (gate > 0).repeat_interleave(tile_m, 0).repeat_interleave(TILE, 1)
    return s.float() * mask[:m, :k]


def spike_matmul_pred_plain(s: torch.Tensor, w: torch.Tensor,
                            occ: torch.Tensor) -> torch.Tensor:
    """Plain version of the predicated kernel: zero the spike tiles whose
    map count is 0, then one dense fp32 matmul over the rest."""
    return torch.matmul(_gated(s, occ), w.float())


def spike_matmul_csr_plain(s: torch.Tensor, w: torch.Tensor,
                           csr: TileCSR) -> torch.Tensor:
    """Plain version of the CSR kernel: the predicated plain version on
    the tiles the work list visits."""
    m, k = s.shape
    return spike_matmul_pred_plain(
        s, w, csr_tile_gate(csr, -(-m // TILE), -(-k // TILE)))


def _fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) of f32 tensors (broadcast), rounded once as the
    card's fused multiply-add rounds it. a * b is exact in fp64; the sum
    is taken in fp64 rounded to odd (TwoSum's error term picks the odd
    neighbour of an inexact sum), which rounds to the same f32 as the exact
    value, since fp64 keeps more than 24 + 1 bits."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.contiguous().view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    return torch.where((err != 0) & even, torch.nextafter(s, away), s).float()


def _fmaf_chain(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """s @ w summed one k column at a time in k order, acc = fmaf(s[:, k],
    w[k], acc) from acc = +0: the serial kernels' arithmetic. On binary s
    each term is exact (acc + w or acc + 0), so f32 adds stand in for the
    fused ones."""
    wf = w.float()
    acc = torch.zeros((s.shape[0], w.shape[1]), device=s.device)
    binary = bool(((s == 0) | (s == 1)).all())
    for c in range(s.shape[1]):
        if binary:
            acc.add_(s[:, c, None] * wf[c])
        else:
            acc = _fmaf(s[:, c, None], wf[c], acc)
    return acc


def spike_matmul_csr_chain_plain(s: torch.Tensor, w: torch.Tensor,
                                 csr: TileCSR) -> torch.Tensor:
    """The serial CSR kernel's arithmetic: s gated by the work list's
    occupied tiles, as `spike_matmul_csr_plain` gates it, then every output
    summed one k column at a time in k order, acc = fmaf(v, w[k], acc)
    (`_fmaf_chain`). The kernel skips zero spikes, which add nothing for
    finite w, so its result equals this bit for bit, binary or multi-bit
    spikes."""
    m, k = s.shape
    return _fmaf_chain(_gated(s, csr_tile_gate(csr, -(-m // TILE),
                                               -(-k // TILE))), w)


def _output(name: str, like: torch.Tensor, shape: tuple,
            route: torch.Tensor | None,
            out: torch.Tensor | None) -> torch.Tensor:
    """The (M, N) f32 output a launch writes: `out` when given (checked),
    else a new one. A gated launch (`route`, a one-element int32 tensor on
    the operands' device: run where nonzero) needs `out`, which it leaves
    untouched when the gate is off."""
    if route is not None:
        if out is None:
            raise ValueError(f"{name}: a gated launch writes into `out`")
        if route.numel() != 1 or route.dtype != torch.int32 or \
                route.device != like.device:
            raise ValueError(f"{name}: `route` must be one int32 on "
                             f"{like.device}, got {tuple(route.shape)} "
                             f"{route.dtype} on {route.device}")
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=like.device)
    if tuple(out.shape) != shape or out.dtype != torch.float32 or \
            out.device != like.device or not out.is_contiguous():
        raise ValueError(f"{name}: `out` must be a contiguous {shape} f32 "
                         f"tensor on {like.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    return out


def _plain_into(result: torch.Tensor, route: torch.Tensor | None,
                out: torch.Tensor | None) -> torch.Tensor:
    """A plain version's `result` as the kernel would leave it: copied into
    `out` unless the gate `route` is off (then `out` stays untouched)."""
    if out is None:
        return result
    if route is None or bool(route.reshape(-1)[0]):
        out.copy_(result)
    return out


def _routed_entry(lib, name: str, route: torch.Tensor | None):
    """(C entry, trailing pointer args) of kernel `name`: `<name>_forward`,
    or `<name>_routed_forward` with the gate's pointer."""
    if route is None:
        return getattr(lib, f"{name}_forward"), ()
    return getattr(lib, f"{name}_routed_forward"), (route.data_ptr(),)


def _csr_matmul(name: str, s: torch.Tensor, w: torch.Tensor, csr: TileCSR,
                plain, *, route: torch.Tensor | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Checks, then the kernel `name` (C entry `<name>_forward`, or the
    gated `<name>_routed_forward` when `route` is given) on CUDA tensors
    or `plain` on CPU ones."""
    if s.ndim != 2 or w.ndim != 2 or s.shape[1] != w.shape[0]:
        raise ValueError(f"{name} needs (M, K) x (K, N), got "
                         f"{tuple(s.shape)} x {tuple(w.shape)}")
    m, k = s.shape
    n = w.shape[1]
    mt, kt = -(-m // TILE), -(-k // TILE)
    csr.check_compatible(TILE, TILE, mt, kt)
    if csr.n_rows != mt:
        raise ValueError(f"csr has {csr.n_rows} m-tile rows, input needs {mt}")
    out = _output(name, s, (m, n), route, out)
    if not s.is_cuda:
        return _plain_into(plain(s, w, csr), route, out)
    row_ptr, kidx, occ = csr.row_ptr, csr.tile_k_idx, csr.occ
    _build.require_cuda(name, s, w, dtype=torch.float32)
    _build.require_cuda(name, row_ptr, kidx, occ, dtype=torch.int32)
    if row_ptr.device != s.device:
        raise ValueError(f"{name}: work list and operands lie on "
                         f"different devices")
    entry, gate = _routed_entry(_build.library(), name, route)
    _build.LAUNCHES[name] += 1
    _build.check(entry(
        s.data_ptr(), w.data_ptr(), out.data_ptr(), row_ptr.data_ptr(),
        kidx.data_ptr(), occ.data_ptr(), m, k, n, mt, *gate,
        _build.stream()), name)
    return out


def spike_matmul_csr(s: torch.Tensor, w: torch.Tensor, csr: TileCSR, *,
                     route: torch.Tensor | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """s: (M, K) f32 spikes, w: (K, N) f32 -> (M, N) f32. With `route` (a
    one-element int32 tensor) the launch is gated: it writes `out` where
    the int is nonzero and nothing otherwise (`_output`)."""
    return _csr_matmul("spike_matmul_csr", s, w, csr, spike_matmul_csr_plain,
                       route=route, out=out)


# ----------------------------------------------------------- the ring
def ring_schedule(occ, kidx, k: int, stages: int = PIPE_STAGES,
                  occ_ov=None) -> list:
    """The copy ring of csrc/tile_mma.cuh over one m-tile row's work-list
    steps (`occ`, `kidx`: the row's per-step counts and k-tile indices, in
    order), run as the kernel runs it. A cursor skips steps with
    occ <= 0 (they issue nothing) and issues PIPE_SLICE-deep k-slices of
    the rest, each as one committed group into slot `issued % stages`,
    `stages - 1` ahead of compute and across step boundaries. For slice
    `done` the consumer waits with `issued - done - 1` groups allowed in
    flight, refills the slot that slice `done - 1` freed, then computes.

    With `occ_ov` (APEC's overlap counts; `occ` the residual's, on a union
    work list) the gate is the union: a step is live when either count is
    positive, each issue copies the operands whose count is positive and
    records them, (residual, overlap), and each compute carries the flags
    of the slot it computes, as the kernel's flags travel with the slot.

    Returns the trace: ("issue", slot, (step, k0)[, copied]), ("wait",
    slot, pending) and ("compute", slot[, live]) events in program
    order."""
    n_steps = len(occ)
    union = occ_ov is not None
    flags = [None] * stages
    trace = []

    def live(st):
        return (occ[st] > 0, occ_ov[st] > 0) if union else (occ[st] > 0,)

    def settle(st):
        while st < n_steps and not any(live(st)):
            st += 1
        return st, 0
    step, kk = settle(0)

    def issue(slot):
        nonlocal step, kk
        flags[slot] = live(step)
        trace.append(("issue", slot, (step, kidx[step] * TILE + kk))
                     + ((flags[slot],) if union else ()))
        kk += PIPE_SLICE
        if kk >= TILE or kidx[step] * TILE + kk >= k:
            step, kk = settle(step + 1)

    issued = 0
    while issued < stages - 1 and step < n_steps:
        issue(issued)
        issued += 1
    done = 0
    while done < issued:
        trace.append(("wait", done % stages, issued - done - 1))
        if step < n_steps:
            issue(issued % stages)
            issued += 1
        trace.append(("compute", done % stages)
                     + ((flags[done % stages],) if union else ()))
        done += 1
    return trace


def check_ring_trace(trace: list, occ, kidx, k: int,
                     stages: int = PIPE_STAGES, occ_ov=None) -> list:
    """Holds a `ring_schedule` trace to the gate contract of `repro`'s
    `_weight_prefetch` and returns the computed (step, k0) slices in
    order. Raises RuntimeError unless: the issued slices are exactly every
    PIPE_SLICE-deep slice before K of the live steps, in order (no copy
    for a dead step); each issued slice is waited on once and computed
    once, in issue order; a wait allows in flight only the groups
    committed after its slice, at most `stages - 2`; and a slot is
    refilled only after its previous slice was computed.

    With `occ_ov` (the union gate) a step is live when either count is
    positive, and the check also refuses a residual copy on a step with
    `occ` 0, an overlap copy on a step with `occ_ov` 0, a live operand
    left uncopied, and a compute whose flags are not its slice's copies
    (a dot on stale ring contents); it returns ((step, k0), (residual,
    overlap)) per computed slice."""
    union = occ_ov is not None

    def live(st):
        return (occ[st] > 0, occ_ov[st] > 0) if union else (occ[st] > 0,)
    want = [(st, kidx[st] * TILE + kk) for st in range(len(occ))
            if any(live(st))
            for kk in range(0, TILE, PIPE_SLICE) if kidx[st] * TILE + kk < k]
    issued, copied, slot_of, computed = [], [], {}, []
    busy = [None] * stages           # slot -> index of the slice it holds
    waited = 0

    def fail(what):
        raise RuntimeError(f"copy ring schedule broken: {what}")
    for ev in trace:
        if ev[0] == "issue":
            slot, item = ev[1], ev[2]
            if busy[slot] is not None:
                fail(f"slot {slot} refilled before slice {busy[slot]} "
                     f"was computed")
            if union:
                st = item[0]
                if not 0 <= st < len(occ):
                    fail(f"issue of step {st} outside the row")
                for name, got, want_op in zip(("residual", "overlap"),
                                              ev[3], live(st)):
                    if got != want_op:
                        fail(f"{name} {'copied' if got else 'not copied'} "
                             f"at step {st} whose count is "
                             f"{'0' if got else 'positive'}")
                copied.append(tuple(ev[3]))
            busy[slot] = len(issued)
            slot_of[len(issued)] = slot
            issued.append(item)
        elif ev[0] == "wait":
            _, slot, pending = ev
            if waited >= len(issued) or slot_of[waited] != slot:
                fail(f"wait {waited} on slot {slot} matches no issued slice")
            if (pending != len(issued) - waited - 1
                    or not 0 <= pending <= stages - 2):
                fail(f"wait {waited} allows {pending} groups in flight with "
                     f"{len(issued)} issued")
            waited += 1
        else:
            slot = ev[1]
            idx = len(computed)
            if (idx >= waited or slot_of.get(idx) != slot
                    or busy[slot] != idx):
                fail(f"slice {idx} computed before its wait or off its slot")
            if union and tuple(ev[2]) != copied[idx]:
                fail(f"slice {idx} computed with flags {ev[2]}, its copies "
                     f"were {copied[idx]}")
            busy[slot] = None
            computed.append((issued[idx], copied[idx]) if union
                            else issued[idx])
    if issued != want:
        fail(f"issued {issued}, the live steps need {want}")
    if waited != len(issued) or len(computed) != len(issued):
        fail(f"{len(issued)} issued, {waited} waited, {len(computed)} "
             f"computed")
    return computed


def _ring_columns(csr: TileCSR, k: int, occ=None, occ_ov=None,
                  stages: int = PIPE_STAGES) -> torch.Tensor:
    """(operands, MT, K) bool: per operand, the columns of each m-tile
    row that the ring (`stages` deep) computes for it, from the row's
    checked schedule (slices of PIPE_SLICE columns). `occ`: per-step
    counts to gate on instead of `csr.occ`; with `occ_ov` (APEC's union
    gate) the result holds the residual's columns, then the overlap's."""
    mt = csr.n_rows
    row_ptr = csr.row_ptr.tolist()
    kidx = csr.tile_k_idx.tolist()
    occ = (csr.occ if occ is None else occ).tolist()
    ov = None if occ_ov is None else occ_ov.tolist()
    cols = torch.zeros((1 if ov is None else 2, mt, k), dtype=torch.bool)
    for r in range(mt):
        b, e = row_ptr[r], row_ptr[r + 1]
        args = (occ[b:e], kidx[b:e], k)
        kw = {"stages": stages}
        if ov is not None:
            kw["occ_ov"] = ov[b:e]
        for item in check_ring_trace(ring_schedule(*args, **kw), *args,
                                     **kw):
            (_, k0), live = (item, (True,)) if ov is None else item
            for op, on in enumerate(live):
                if on:
                    cols[op, r, k0:k0 + PIPE_SLICE] = True
    return cols


# ------------------------------------------------ kernel 10's TMA ring
def _map_slices(row, k: int) -> list:
    """The live slices of one map row in the cursor's order
    (`tile_mma::RowCursor<OneGate, TileIndex>`): (k-tile, k0) for every
    PIPE_SLICE-deep slice before K of each k-tile whose count is > 0."""
    return [(j, j * TILE + kk) for j, o in enumerate(row) if o > 0
            for kk in range(0, TILE, PIPE_SLICE) if j * TILE + kk < k]


def tma_ring_programs(rows, k: int, stages: int = WIDE_STAGES,
                      warps: int = 2) -> tuple:
    """The two sides of kernel 10's TMA form in one block, as programs:
    its loops in csrc/spike_matmul.cu (`pred_tma_kernel`) written out over
    the map rows of the tiles the block walks (`rows`, in its order). The
    producer, for the block's `slice`-th live slice, waits on the stage's
    `empty` barrier for fill (slice // stages) - 1 (none for a stage's
    first fill), then arms `full` and issues the slice's boxes. Each
    consumer warp (`warps` of them; the kernel has 8) waits on `full` for
    that fill, computes, arrives on `empty` once, and stores each tile
    after its last slice. Ops: ("wait", barrier, slot, parity, phase
    meant), ("issue", slot, (tile, k0)), ("compute", slot, (tile, k0)),
    ("arrive", slot), ("store", tile). Returns (producer, [consumers])."""
    producer, consumer, slice_ = [], [], 0
    for t, row in enumerate(rows):
        for _, k0 in _map_slices(row, k):
            slot, fill = slice_ % stages, slice_ // stages
            if fill > 0:
                producer.append(("wait", "empty", slot, (fill - 1) & 1,
                                 fill - 1))
            producer.append(("issue", slot, (t, k0)))
            consumer += [("wait", "full", slot, fill & 1, fill),
                         ("compute", slot, (t, k0)), ("arrive", slot)]
            slice_ += 1
        consumer.append(("store", t))
    return producer, [list(consumer) for _ in range(warps)]


def run_tma_ring(producer: list, consumers: list, stages: int = WIDE_STAGES,
                 choose=None, arrivals: int | None = None) -> dict:
    """Runs the programs against a model of the ring's mbarriers and
    returns, per tile, the k0 of the slices its consumers computed, in
    order (every warp must compute the same). `choose(n)` picks which of
    the n runnable events goes next (the producer's next op, each
    consumer warp's next op, or the landing of an issued box pair, in that
    order); None takes the first. A barrier's phase count `ph` rises by
    one when its phase completes (`full`: the slice's boxes land; `empty`:
    `arrivals` arrivals, one a consumer warp unless given); a wait with
    parity p passes while ph % 2 != p, as `mbarrier.try_wait.parity`
    does. Raises RuntimeError unless: every wait that passes finds exactly
    the phase it means completed (ph == meant + 1: not an older phase, not
    a stage that ran a lap ahead); no box is issued into a stage a warp is
    still reading, or whose previous boxes have not landed; each compute
    reads the slice it expects, landed; and every program ends (no wait
    left hanging)."""
    progs = [producer, *consumers]
    arrivals = len(consumers) if arrivals is None else arrivals
    ph = {(bar, s): 0 for bar in ("full", "empty") for s in range(stages)}
    pending = [0] * stages           # arrivals on `empty` this phase
    content = [None] * stages        # slot -> (item, landed)
    reading = [set() for _ in range(stages)]
    flight: list = []                # issued slots whose boxes are in flight
    pc = [0] * len(progs)
    out: list = [{} for _ in consumers]

    def fail(what):
        raise RuntimeError(f"TMA ring schedule broken: {what}")

    def ready(side):
        if pc[side] >= len(progs[side]):
            return False
        op = progs[side][pc[side]]
        return op[0] != "wait" or ph[(op[1], op[2])] % 2 != op[3]
    while True:
        events = [side for side in range(len(progs)) if ready(side)]
        events += [-1 - j for j in range(len(flight))]
        if not events:
            break
        ev = events[0 if choose is None else choose(len(events))]
        if ev < 0:                                   # a box pair lands
            slot = flight.pop(-1 - ev)
            content[slot] = (content[slot][0], True)
            ph[("full", slot)] += 1
            continue
        op = progs[ev][pc[ev]]
        pc[ev] += 1
        if op[0] == "wait":
            _, bar, slot, _, meant = op
            if ph[(bar, slot)] != meant + 1:
                fail(f"{'producer' if ev == 0 else f'warp {ev - 1}'} wait "
                     f"on {bar}[{slot}] for phase {meant} passed at phase "
                     f"count {ph[(bar, slot)]}")
            if bar == "full":
                reading[slot].add(ev)
        elif op[0] == "issue":
            slot = op[1]
            if reading[slot]:
                fail(f"issue into stage {slot} while warps "
                     f"{sorted(reading[slot])} read it")
            if slot in flight:
                fail(f"issue into stage {slot} before its boxes landed")
            content[slot] = (op[2], False)
            flight.append(slot)
        elif op[0] == "compute":
            slot, item = op[1], op[2]
            if ev not in reading[slot] or content[slot] != (item, True):
                fail(f"compute of {item} found stage {slot} holding "
                     f"{content[slot]}")
            out[ev - 1].setdefault(item[0], []).append(item[1])
        elif op[0] == "arrive":
            reading[op[1]].discard(ev)
            pending[op[1]] += 1
            if pending[op[1]] == arrivals:
                pending[op[1]] = 0
                ph[("empty", op[1])] += 1
        else:
            out[ev - 1].setdefault(op[1], [])
    if pc != [len(prog) for prog in progs]:
        fail(f"hung: programs at {pc} of {[len(prog) for prog in progs]}")
    if any(o != out[0] for o in out):
        fail("consumer warps computed different slices")
    return out[0]


def tma_ring_columns(occ: torch.Tensor, k: int, blocks: int = 1,
                     stages: int = WIDE_STAGES, choose=None) -> torch.Tensor:
    """(MT, K) bool: the columns of each m-tile row that kernel 10's TMA
    form computes, its rows shared out over `blocks` persistent blocks as
    the kernel walks them (block b takes tiles b, b + blocks, ...), each
    block's schedule run and checked (`run_tma_ring`)."""
    mt = occ.shape[0]
    rows = occ.tolist()
    cols = torch.zeros((mt, k), dtype=torch.bool)
    for b in range(blocks):
        mine = list(range(b, mt, blocks))
        done = run_tma_ring(*tma_ring_programs([rows[r] for r in mine], k,
                                               stages), stages, choose)
        for t, k0s in done.items():
            for k0 in k0s:
                cols[mine[t], k0:k0 + PIPE_SLICE] = True
    return cols


def spike_matmul_csr_pipe_plain(s: torch.Tensor, w: torch.Tensor,
                                csr: TileCSR) -> torch.Tensor:
    """Plain version of the pipelined CSR kernel: the CPU twin of its copy
    ring (`ring_schedule`, held to the gate contract by
    `check_ring_trace`) gates the spikes the ring computes, then one dense
    fp32 matmul, the product of `spike_matmul_csr_plain`."""
    m, k = s.shape
    cols = _ring_columns(csr, k)[0].repeat_interleave(TILE, 0)[:m]
    return torch.matmul(s.float() * cols.to(s.device), w.float())


def spike_matmul_csr_pipe(s: torch.Tensor, w: torch.Tensor,
                          csr: TileCSR) -> torch.Tensor:
    """`spike_matmul_csr` on the pipelined kernel: s (M, K)
    f32 spikes, w (K, N) f32 -> (M, N) f32."""
    return _csr_matmul("spike_matmul_csr_pipe", s, w, csr,
                       spike_matmul_csr_pipe_plain)


def spike_matmul_pred(s: torch.Tensor, w: torch.Tensor, occ: torch.Tensor,
                      *, route: torch.Tensor | None = None,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """s: (M, K) f32 spikes (binary, or multi-bit at a coded input),
    w: (K, N) f32, occ: (ceil(M/128), ceil(K/128)) int32 per-tile event
    counts -> (M, N) f32. `route` / `out`: a gated launch, as in
    `spike_matmul_csr`."""
    if s.ndim != 2 or w.ndim != 2 or s.shape[1] != w.shape[0]:
        raise ValueError(f"spike_matmul_pred needs (M, K) x (K, N), got "
                         f"{tuple(s.shape)} x {tuple(w.shape)}")
    m, k = s.shape
    n = w.shape[1]
    grid = (-(-m // TILE), -(-k // TILE))
    if tuple(occ.shape) != grid:
        raise ValueError(f"occupancy map {tuple(occ.shape)} does not match "
                         f"the {grid} tile grid of {tuple(s.shape)}")
    out = _output("spike_matmul_pred", s, (m, n), route, out)
    if not s.is_cuda:
        return _plain_into(spike_matmul_pred_plain(s, w, occ), route, out)
    _build.require_cuda("spike_matmul_pred", s, w, dtype=torch.float32)
    _build.require_cuda("spike_matmul_pred", occ, dtype=torch.int32)
    if occ.device != s.device:
        raise ValueError("spike_matmul_pred: map and operands lie on "
                         "different devices")
    entry, gate = _routed_entry(_build.library(), "spike_matmul_pred", route)
    _build.LAUNCHES["spike_matmul_pred"] += 1
    _build.check(entry(
        s.data_ptr(), w.data_ptr(), out.data_ptr(), occ.data_ptr(), m, k, n,
        grid[1], *gate, _build.stream()), "spike_matmul_pred")
    return out


PRED_FORMS = ("stream", "ring", "tma")


def pred_launch(m: int, k: int, n: int, aligned: bool = True) -> dict:
    """The launch kernel 10 makes for an (M, K) x (K, N) product whose
    operands are 16-byte aligned or not, as its C library reports it: the
    form (the narrow stream for N <= 16; the TMA ring, or the cp.async
    ring where TMA cannot describe an operand), n-tile width, the rows
    and columns a thread holds, grid blocks, blocks an SM, ring stages,
    and waves (tiles over the card's SMs times the blocks an SM holds).
    Needs a card."""
    got = (ctypes.c_int * 7)()
    _build.check(_build.library().spike_matmul_pred_launch(
        m, k, n, int(aligned), got), "spike_matmul_pred_launch")
    form, bn, rows, cols, grid, per_sm, stages = got
    tiles = -(-m // TILE) * (1 if form == 0 else -(-n // bn))
    return {"form": PRED_FORMS[form], "bn": bn, "thread_tile": [rows, cols],
            "grid": grid, "tiles": tiles, "per_sm": per_sm,
            "stages": stages, "waves": tiles / (per_sm * _sm_count())}


def _sm_count() -> int:
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


def _apec_group_ok(g: int) -> bool:
    """The fused kernels' group sizes: every g dividing the 128-row tile
    (a group never straddles two output tiles), g = 1 included."""
    return 1 <= g <= TILE and TILE % g == 0


def _apec_product(res: torch.Tensor, ov: torch.Tensor, w: torch.Tensor,
                  g: int) -> torch.Tensor:
    """res @ w + repeat_interleave(ov @ w, g) in dense fp32."""
    wf = w.float()
    return torch.matmul(res.float(), wf) + \
        torch.matmul(ov.float(), wf).repeat_interleave(g, 0)


def apec_matmul_csr_plain(res: torch.Tensor, ov: torch.Tensor,
                          w: torch.Tensor, g: int, csr: TileCSR,
                          occ_res: torch.Tensor,
                          occ_ov: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused APEC kernel: each operand's tiles gated
    by its own per-step counts on the union work list (residual tiles
    128 x 128, overlap tiles 128/g x 128 on the same grid), then
    res @ w + repeat_interleave(ov @ w, g) in dense fp32."""
    m, k = res.shape
    mt, kt = -(-m // TILE), -(-k // TILE)
    return _apec_product(_gated(res, csr_tile_gate(csr, mt, kt, occ_res)),
                         _gated(ov, csr_tile_gate(csr, mt, kt, occ_ov),
                                TILE // g), w, g)


def apec_matmul_csr_chain_plain(res: torch.Tensor, ov: torch.Tensor,
                                w: torch.Tensor, g: int, csr: TileCSR,
                                occ_res: torch.Tensor,
                                occ_ov: torch.Tensor) -> torch.Tensor:
    """The serial APEC kernel's arithmetic: each operand gated by its own
    per-step counts as `apec_matmul_csr_plain` gates it, then each summed
    as the serial CSR kernel sums it (`_fmaf_chain`: one k column at a time
    in k order, acc = fmaf(v, w[k], acc)), the residual and overlap sums
    apart and added last (acc_res + repeat_interleave(acc_ov, g)). The
    kernel skips zero spikes, which add nothing, so its result equals this
    bit for bit."""
    m, k = res.shape
    mt, kt = -(-m // TILE), -(-k // TILE)
    r = _gated(res, csr_tile_gate(csr, mt, kt, occ_res))
    o = _gated(ov, csr_tile_gate(csr, mt, kt, occ_ov), TILE // g)
    return _fmaf_chain(r, w) + _fmaf_chain(o, w).repeat_interleave(g, 0)


def apec_matmul_csr_pipe_plain(res: torch.Tensor, ov: torch.Tensor,
                               w: torch.Tensor, g: int, csr: TileCSR,
                               occ_res: torch.Tensor,
                               occ_ov: torch.Tensor) -> torch.Tensor:
    """Plain version of the pipelined APEC kernel: the union-gated twin of
    its copy ring (`ring_schedule(..., occ_ov=, stages=APEC_PIPE_STAGES)`,
    checked) gates each operand's columns by the slices the ring copies
    and computes for it, then the fused kernel's dense fp32 product (the
    kernel sums the same products on the tensor cores, `split_bf16x3`)."""
    m, k = res.shape
    cols = _ring_columns(csr, k, occ_res, occ_ov,
                         APEC_PIPE_STAGES).to(res.device)
    return _apec_product(
        res.float() * cols[0].repeat_interleave(TILE, 0)[:m],
        ov.float() * cols[1].repeat_interleave(TILE // g, 0)[:ov.shape[0]],
        w, g)


def split_bf16x3(w: torch.Tensor) -> tuple:
    """(hi, mid, lo), f32 tensors of bf16 values with hi + mid + lo == w
    exactly: hi = RN_bf16(w), mid = RN_bf16(w - hi), lo = RN_bf16(w - hi -
    mid), the split the pipelined APEC kernels make of their weights
    (csrc/tile_tc.cuh). Each part takes the next 8 of w's 24 significant
    bits, so both subtractions are exact; every part is a normal number
    for |w| >= 2^-100."""
    def part(x):
        return x.to(torch.bfloat16).float()
    w = w.float()
    hi = part(w)
    mid = part(w - hi)
    return hi, mid, part(w - hi - mid)


def _apec_matmul(name: str, res: torch.Tensor, ov: torch.Tensor,
                 w: torch.Tensor, g: int, csr: TileCSR,
                 occ_res: torch.Tensor, occ_ov: torch.Tensor, plain, *,
                 packed: bool, route: torch.Tensor | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Checks, then the fused APEC kernel `name` (C entry `<name>_forward`,
    or the gated `<name>_routed_forward` when `route` is given) on CUDA
    tensors or `plain` on CPU ones; `packed`: res and ov are uint32
    words."""
    if w.ndim != 2:
        raise ValueError(f"{name} needs (K, N) weights, got "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    if packed:
        _check_words(name, k, res, ov)
    elif res.ndim != 2 or ov.ndim != 2 or res.shape[1] != k or \
            ov.shape[1] != k:
        raise ValueError(f"{name} needs (M, K), (M/g, K) x (K, N), got "
                         f"{tuple(res.shape)}, {tuple(ov.shape)} x "
                         f"{tuple(w.shape)}")
    m = res.shape[0]
    if not _apec_group_ok(g) or m % g or ov.shape[0] * g != m:
        raise ValueError(f"{name} takes g dividing {TILE} with M % g == 0 "
                         f"and M/g overlap rows, got g={g}, M={m}, "
                         f"{ov.shape[0]} overlap rows")
    mt, kt = -(-m // TILE), -(-k // TILE)
    csr.check_compatible(TILE, TILE, mt, kt)
    if csr.n_rows != mt:
        raise ValueError(f"csr has {csr.n_rows} m-tile rows, input needs {mt}")
    if occ_res.shape != (csr.n_steps,) or occ_ov.shape != (csr.n_steps,):
        raise ValueError(f"per-step counts {tuple(occ_res.shape)} / "
                         f"{tuple(occ_ov.shape)} do not match the "
                         f"work list's {csr.n_steps} steps")
    out = _output(name, res, (m, n), route, out)
    if not res.is_cuda:
        return _plain_into(plain(res, ov, w, g, csr, occ_res, occ_ov), route,
                           out)
    _build.require_cuda(name, res, ov,
                        dtype=torch.uint32 if packed else torch.float32)
    _build.require_cuda(name, w, dtype=torch.float32)
    _build.require_cuda(name, csr.row_ptr, csr.tile_k_idx, occ_res, occ_ov,
                        dtype=torch.int32)
    if w.device != res.device or csr.row_ptr.device != res.device:
        raise ValueError(f"{name}: operands and work list lie on different "
                         f"devices")
    dims = (m, res.shape[1], k, n) if packed else (m, k, n)
    entry, gate = _routed_entry(_build.library(), name, route)
    _build.LAUNCHES[name] += 1
    _build.check(entry(
        res.data_ptr(), ov.data_ptr(), w.data_ptr(), out.data_ptr(),
        csr.row_ptr.data_ptr(), csr.tile_k_idx.data_ptr(),
        occ_res.data_ptr(), occ_ov.data_ptr(), *dims, mt, g, *gate,
        _build.stream()), name)
    return out


def apec_matmul_csr(res: torch.Tensor, ov: torch.Tensor, w: torch.Tensor,
                    g: int, csr: TileCSR, occ_res_steps: torch.Tensor,
                    occ_ov_steps: torch.Tensor, *,
                    route: torch.Tensor | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """res: (M, K) f32 residual spikes (group members adjacent), ov:
    (M/g, K) f32 overlap spikes, w: (K, N) f32; `csr` a union work list on
    the 128 x 128 grid of res (a step where either operand's tile holds
    events), `occ_res_steps` / `occ_ov_steps` (cap,) int32 per-step counts
    of each operand -> (M, N) f32 = res @ w + repeat(ov @ w, g). `route` /
    `out`: a gated launch, as in `spike_matmul_csr`."""
    return _apec_matmul("apec_matmul_csr", res, ov, w, g, csr,
                        occ_res_steps, occ_ov_steps, apec_matmul_csr_plain,
                        packed=False, route=route, out=out)


def apec_matmul_csr_pipe(res: torch.Tensor, ov: torch.Tensor,
                         w: torch.Tensor, g: int, csr: TileCSR,
                         occ_res_steps: torch.Tensor,
                         occ_ov_steps: torch.Tensor) -> torch.Tensor:
    """`apec_matmul_csr` on the pipelined kernel (the same sums)."""
    return _apec_matmul("apec_matmul_csr_pipe", res, ov, w, g, csr,
                        occ_res_steps, occ_ov_steps,
                        apec_matmul_csr_pipe_plain, packed=False)


# ------------------------------------------------------------- packed
def _check_words(name: str, k: int, *words: torch.Tensor) -> None:
    for p in words:
        if p.ndim != 2 or p.dtype != torch.uint32 or \
                p.shape[1] != packed_width(k):
            raise ValueError(
                f"{name} needs (rows, {packed_width(k)}) uint32 words for "
                f"K={k}, got {tuple(p.shape)} {p.dtype}")


def spike_matmul_packed_csr_plain(p: torch.Tensor, w: torch.Tensor,
                                  csr: TileCSR) -> torch.Tensor:
    """Plain version of the packed CSR kernel: unpack, then the f32 CSR
    kernel's plain version."""
    return spike_matmul_csr_plain(unpack_spikes_padded(p, w.shape[0]), w,
                                  csr)


def spike_matmul_packed_csr_chain_plain(p: torch.Tensor, w: torch.Tensor,
                                        csr: TileCSR) -> torch.Tensor:
    """The packed CSR kernel's arithmetic: unpack, then
    `spike_matmul_csr_chain_plain` (the kernel's sums bit for bit)."""
    return spike_matmul_csr_chain_plain(unpack_spikes_padded(p, w.shape[0]),
                                        w, csr)


def _packed_csr_matmul(name: str, p: torch.Tensor, w: torch.Tensor,
                       csr: TileCSR, plain) -> torch.Tensor:
    """Checks, then the word kernel `name` on CUDA tensors or `plain` on
    CPU ones."""
    if w.ndim != 2:
        raise ValueError(f"{name} needs (K, N) weights, got "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    _check_words(name, k, p)
    m, kw = p.shape
    mt, kt = -(-m // TILE), -(-k // TILE)
    csr.check_compatible(TILE, TILE, mt, kt)
    if csr.n_rows != mt:
        raise ValueError(f"csr has {csr.n_rows} m-tile rows, input needs {mt}")
    if not p.is_cuda:
        return plain(p, w, csr)
    _build.require_cuda(name, p, dtype=torch.uint32)
    _build.require_cuda(name, w, dtype=torch.float32)
    _build.require_cuda(name, csr.row_ptr, csr.tile_k_idx, csr.occ,
                        dtype=torch.int32)
    if w.device != p.device or csr.row_ptr.device != p.device:
        raise ValueError(f"{name}: operands and work list lie on different "
                         f"devices")
    out = torch.empty((m, n), dtype=torch.float32, device=p.device)
    lib = _build.library()
    _build.LAUNCHES[name] += 1
    _build.check(getattr(lib, f"{name}_forward")(
        p.data_ptr(), w.data_ptr(), out.data_ptr(), csr.row_ptr.data_ptr(),
        csr.tile_k_idx.data_ptr(), csr.occ.data_ptr(), m, kw, k, n, mt,
        _build.stream()), name)
    return out


def spike_matmul_packed_csr(p: torch.Tensor, w: torch.Tensor,
                            csr: TileCSR) -> torch.Tensor:
    """p: (M, ceil(K/32)) uint32 words of binary spikes, w: (K, N) f32 ->
    (M, N) f32, `csr` a work list on the 128 x 128 grid of the unpacked
    (M, K) matrix."""
    return _packed_csr_matmul("spike_matmul_packed_csr", p, w, csr,
                              spike_matmul_packed_csr_plain)


def _pipe_launch(entry: str, n: int, mt: int) -> dict:
    """The launch a pipelined CSR kernel makes for N columns and MT m-tile
    rows, as its C library's `entry` reports it: n-tile width, the rows
    and columns a thread holds, grid, blocks and waves (blocks over the
    card's SMs times the blocks an SM holds). Needs a card."""
    got = (ctypes.c_int * 5)()
    _build.check(getattr(_build.library(), entry)(n, mt, got), entry)
    bn, rows, cols, sms, per_sm = got
    blocks = mt * -(-n // bn)
    return {"bn": bn, "thread_tile": [rows, cols], "grid": [mt, -(-n // bn)],
            "blocks": blocks, "waves": blocks / (per_sm * sms)}


def pipe_launch(n: int, mt: int) -> dict:
    """The f32 kernel's launch (`_pipe_launch`)."""
    return _pipe_launch("spike_matmul_csr_pipe_launch", n, mt)


def packed_pipe_launch(n: int, mt: int) -> dict:
    """The word kernel's launch (`_pipe_launch`)."""
    return _pipe_launch("spike_matmul_packed_csr_pipe_launch", n, mt)


def spike_matmul_packed_csr_pipe_plain(p: torch.Tensor, w: torch.Tensor,
                                       csr: TileCSR) -> torch.Tensor:
    """Plain version of the pipelined word kernel: unpack, then the
    pipelined f32 kernel's plain version (its ring twin included)."""
    return spike_matmul_csr_pipe_plain(unpack_spikes_padded(p, w.shape[0]),
                                       w, csr)


def spike_matmul_packed_csr_pipe(p: torch.Tensor, w: torch.Tensor,
                                 csr: TileCSR) -> torch.Tensor:
    """`spike_matmul_packed_csr` on the pipelined kernel, which tests the
    words' bits in registers and adds the weight rows of the set ones
    (the same sums as kernel 12 on the unpacked spikes)."""
    return _packed_csr_matmul("spike_matmul_packed_csr_pipe", p, w, csr,
                              spike_matmul_packed_csr_pipe_plain)


def apec_matmul_packed_csr_plain(res: torch.Tensor, ov: torch.Tensor,
                                 w: torch.Tensor, g: int, csr: TileCSR,
                                 occ_res: torch.Tensor,
                                 occ_ov: torch.Tensor) -> torch.Tensor:
    """Plain version of the packed APEC kernel: unpack both operands, then
    the f32 APEC kernel's plain version."""
    k = w.shape[0]
    return apec_matmul_csr_plain(unpack_spikes_padded(res, k),
                                 unpack_spikes_padded(ov, k), w, g, csr,
                                 occ_res, occ_ov)


def apec_matmul_packed_csr_chain_plain(res: torch.Tensor, ov: torch.Tensor,
                                       w: torch.Tensor, g: int,
                                       csr: TileCSR, occ_res: torch.Tensor,
                                       occ_ov: torch.Tensor) -> torch.Tensor:
    """The packed APEC kernel's arithmetic: unpack both operands, then
    `apec_matmul_csr_chain_plain` (the kernel's sums bit for bit)."""
    k = w.shape[0]
    return apec_matmul_csr_chain_plain(unpack_spikes_padded(res, k),
                                       unpack_spikes_padded(ov, k), w, g,
                                       csr, occ_res, occ_ov)


def apec_matmul_packed_csr_pipe_plain(res: torch.Tensor, ov: torch.Tensor,
                                      w: torch.Tensor, g: int, csr: TileCSR,
                                      occ_res: torch.Tensor,
                                      occ_ov: torch.Tensor) -> torch.Tensor:
    """Plain version of the pipelined packed APEC kernel: unpack both
    operands, then the pipelined f32 APEC kernel's plain version (its
    ring twin included)."""
    k = w.shape[0]
    return apec_matmul_csr_pipe_plain(unpack_spikes_padded(res, k),
                                      unpack_spikes_padded(ov, k), w, g, csr,
                                      occ_res, occ_ov)


def apec_matmul_packed_csr(res: torch.Tensor, ov: torch.Tensor,
                           w: torch.Tensor, g: int, csr: TileCSR,
                           occ_res_steps: torch.Tensor,
                           occ_ov_steps: torch.Tensor) -> torch.Tensor:
    """`apec_matmul_csr` on words: res (M, ceil(K/32)) and ov
    (M/g, ceil(K/32)) uint32, w (K, N) f32 -> (M, N) f32 =
    res @ w + repeat(ov @ w, g)."""
    return _apec_matmul("apec_matmul_packed_csr", res, ov, w, g, csr,
                        occ_res_steps, occ_ov_steps,
                        apec_matmul_packed_csr_plain, packed=True)


def apec_matmul_packed_csr_pipe(res: torch.Tensor, ov: torch.Tensor,
                                w: torch.Tensor, g: int, csr: TileCSR,
                                occ_res_steps: torch.Tensor,
                                occ_ov_steps: torch.Tensor) -> torch.Tensor:
    """`apec_matmul_packed_csr` on the pipelined kernel, which unpacks
    both operands' words in registers."""
    return _apec_matmul("apec_matmul_packed_csr_pipe", res, ov, w, g, csr,
                        occ_res_steps, occ_ov_steps,
                        apec_matmul_packed_csr_pipe_plain, packed=True)
