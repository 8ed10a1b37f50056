"""Process groups and rank launch for the port's multi-process runs.

The reference has no counterpart: JAX's runtime places one program over
every device. The port runs one process a rank over `torch.distributed`:

  * `init(backend, device, init_method=None)` joins the process group
    with an explicit backend, ``"nccl"`` or ``"gloo"``, at an explicit
    address (``tcp://127.0.0.1:<port>``, or ``env://`` under `torchrun`).
    Under ``nccl`` a rank runs on ``cuda:<local rank>``; under ``gloo`` on
    the device the caller names (``"cpu"`` in the tests, ``"cuda:0"`` for
    several ranks sharing one card). No backend is switched on its own:
    NCCL refuses two ranks on one card, and that error stands; a run
    that wants several ranks on one card asks for ``gloo`` by name.
  * `spawn(fn, nprocs, ...)` starts `nprocs` ranks with the ``spawn``
    start method on a free local port, runs ``fn(*args)`` in each, and
    joins them with a deadline. A rank that raises makes `spawn` raise
    with that rank's traceback; a rank that hangs past the deadline makes
    it raise with the stacks of the ranks still running. Every process it
    starts is ended before it returns.

Collectives: of the two that ``gloo`` implements on CUDA tensors,
`broadcast` and `all_reduce`, the port's multi-process paths use
`all_reduce` alone (`all_reduce_`), so one card can rehearse them under
``gloo``. An all-gather is an `all_reduce` into a zeroed buffer with each
rank's slot filled (`runtime.sharding.full_leaves`).
"""
from __future__ import annotations

import contextlib
import datetime
import faulthandler
import io
import os
import signal
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

# The rank's device and backend, set by `init` (the process group itself
# is process-wide state of `torch.distributed`).
_STATE: dict = {}


def free_port() -> int:
    """A local TCP port that was free when asked (bound to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def under_torchrun() -> bool:
    """Whether `torchrun` launched this process (its rank, world size and
    master address are in the environment)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def init(backend: str, device, init_method: Optional[str] = None, *,
         rank: Optional[int] = None, world_size: Optional[int] = None,
         timeout_s: float = 600.0) -> torch.device:
    """Join the process group and return this rank's device.

    `backend` must be ``"nccl"`` or ``"gloo"``. `init_method` None means
    ``env://`` (under `torchrun`, which sets RANK, WORLD_SIZE and the
    master address); otherwise ``tcp://127.0.0.1:<port>`` with `rank` and
    `world_size`. Under ``nccl`` the device is ``cuda:<local rank>``
    (LOCAL_RANK, else the rank modulo the visible cards) and `device` is
    ignored; under ``gloo`` it is `device`, which may name one card for
    every rank. Asking for ``nccl`` with no card raises."""
    from repro_torch import resolve_device
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if init_method is None:
        if not under_torchrun():
            raise ValueError("no init_method given and no torchrun "
                             "environment (RANK, WORLD_SIZE, MASTER_ADDR, "
                             "MASTER_PORT)")
        init_method = "env://"
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the nccl backend needs a card, and "
                "torch.cuda.is_available() is False; ask for gloo by name "
                "to run ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _STATE.update(backend=backend, device=dev)
    print(f"[dist] backend={backend} rank={rank}/{world_size} device={dev}",
          flush=True)
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def device() -> torch.device:
    """This rank's device (as `init` chose it)."""
    if not is_initialized():
        raise RuntimeError("no process group: call distributed.init first")
    return _STATE["device"]


def backend() -> str:
    if not is_initialized():
        raise RuntimeError("no process group: call distributed.init first")
    return _STATE["backend"]


def control_device() -> torch.device:
    """Where small control values (counts, steps, flags) are reduced: the
    CPU under ``gloo``, the rank's card under ``nccl``."""
    return torch.device("cpu") if backend() == "gloo" else device()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()
    _STATE.clear()


def all_reduce_(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """`t` reduced over `group` in place, and returned. Every caller in the
    port reduces through here."""
    dist.all_reduce(t, op=op, group=group)
    return t


def reduce_int(value: int, group=None, op=dist.ReduceOp.MIN) -> int:
    """An integer reduced over `group` (a host value; control flow)."""
    t = torch.tensor([value], dtype=torch.int64, device=control_device())
    return int(all_reduce_(t, group, op).item())


def barrier(group=None) -> None:
    """Every rank of `group` waits for the others: an `all_reduce` of one
    element."""
    reduce_int(0, group, dist.ReduceOp.SUM)


@contextlib.contextmanager
def single_rank(backend: str, device="cpu"):
    """This process as the one rank of a fresh group (a free local port),
    for the block; yields the rank's device and leaves the group after.
    Under ``nccl`` its collectives run NCCL's one-rank path on the card."""
    dev = init(backend, device, f"tcp://127.0.0.1:{free_port()}", rank=0,
               world_size=1)
    try:
        yield dev
    finally:
        shutdown()


# ---------------------------------------------------------------- spawn
def _rank_entry(fn: Callable, rank_: int, nprocs: int, backend_: str,
                device_, init_method: str, queue, stack_dir: str,
                args: Sequence[Any]) -> None:
    """One rank: join the group, run `fn`, send back ("ok", bytes of the
    result) or ("error", traceback); leave the group."""
    stacks = open(os.path.join(stack_dir, f"rank{rank_}.stack"), "w")
    faulthandler.register(signal.SIGUSR1, file=stacks, all_threads=True)
    try:
        dev = init(backend_, device_, init_method, rank=rank_,
                   world_size=nprocs)
        if dev.type == "cpu":      # share the host's cores among the ranks
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
        out = fn(*args)
        buf = io.BytesIO()
        torch.save(out, buf)
        queue.put((rank_, "ok", buf.getvalue()))
    except BaseException:
        queue.put((rank_, "error", traceback.format_exc()))
        raise
    finally:
        try:
            shutdown()
        finally:
            stacks.close()


def _end(procs) -> None:
    procs = [p for p in procs if p.pid is not None]     # the started ones
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)


def spawn(fn: Callable, nprocs: int, *, backend: str, device="cpu",
          timeout_s: float = 120.0, args: Sequence[Any] = ()) -> list:
    """Run ``fn(*args)`` in `nprocs` new processes, ranks 0..nprocs-1 of a
    fresh process group (`init` with `backend` and `device` over a free
    ``tcp://127.0.0.1`` port), and return their results in rank order.

    `fn` must be importable by name (a module-level function: the spawn
    start method imports it in each child); its result is sent back with
    `torch.save` and loaded on the CPU. Joins with one deadline of
    `timeout_s` seconds for all ranks: a rank that raises makes this
    raise RuntimeError with its traceback, and one still running at the
    deadline makes it raise TimeoutError with the stacks of the ranks
    still running. Every rank is ended before this returns or raises."""
    import torch.multiprocessing as tmp
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    ctx = tmp.get_context("spawn")
    queue = ctx.SimpleQueue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    results: dict = {}
    with tempfile.TemporaryDirectory() as stack_dir:
        procs = [ctx.Process(target=_rank_entry, daemon=False, args=(
            fn, r, nprocs, backend, device, init_method, queue, stack_dir,
            tuple(args))) for r in range(nprocs)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            while len(results) < nprocs:
                if not queue.empty():
                    r, status, payload = queue.get()
                    if status == "error":
                        raise RuntimeError(
                            f"rank {r} of {nprocs} failed:\n{payload}")
                    results[r] = payload
                    continue
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                if dead and queue.empty():
                    # A rank may have exited between the two reads: give
                    # its message a moment to arrive.
                    time.sleep(0.5)
                    if queue.empty():
                        raise RuntimeError(
                            f"rank(s) {dead} of {nprocs} exited without a "
                            f"result (exit codes "
                            f"{[procs[r].exitcode for r in dead]})")
                    continue
                if time.monotonic() > deadline:
                    waiting = [r for r in range(nprocs) if r not in results]
                    for r in waiting:
                        if procs[r].is_alive():
                            try:
                                os.kill(procs[r].pid, signal.SIGUSR1)
                            except ProcessLookupError:
                                pass
                    time.sleep(1.0)
                    stacks = []
                    for r in waiting:
                        path = os.path.join(stack_dir, f"rank{r}.stack")
                        with open(path) as f:
                            stacks.append(f"--- rank {r}\n{f.read()}")
                    raise TimeoutError(
                        f"rank(s) {waiting} of {nprocs} still running after "
                        f"{timeout_s:.0f} s:\n" + "\n".join(stacks))
                time.sleep(0.05)
        finally:
            _end(procs)
    return [torch.load(io.BytesIO(results[r]), map_location="cpu",
                       weights_only=False) for r in range(nprocs)]
