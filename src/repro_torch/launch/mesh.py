"""Device meshes for the single-controller port, the counterpart of
`repro.launch.mesh`.

One process holds a logical mesh: axis names (`pod`, `data`, `model`),
a shape, and one `torch.device` per position. Positions may repeat a
device, so an 8-position `data` mesh can live on one card: what such a
mesh shows is the per-shard work (each shard's rows, work list and
kernel launch), not any placement across cards. `shard_map` is the
per-shard executor: it splits the leading row axis into contiguous equal
slices, runs the body on each slice on its position's device, and
concatenates the results in shard order on the caller's device.

A `RankMesh` (`make_rank_mesh`) is the other kind: its positions are the
ranks of a `torch.distributed` process group (`launch.distributed`), one
process each, row-major as JAX lays devices out. Each rank holds its own
data shard's rows and its own slice of the expert banks; `axis_group`
gives the sub-group over which a rank reduces along one axis. The
data-parallel training step, the expert-parallel MoE and the elastic
restore run over it. What is still missing (tensor-parallel and FSDP
placement of the other leaves, pure FSDP, sharded event ops on their own
ranks, a multi-pod mesh) is `MULTI_PROCESS_ITEM`.

The hardware constants below are the roofline denominators of the port,
one NVIDIA H100 SXM (NVIDIA H100 80GB HBM3, 700 W), from NVIDIA's H100
data sheet: dense rates, without sparsity.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, fp32 outside the tensor cores
PEAK_FLOPS_TF32 = 495e12        # FLOP/s, TF32 tensor cores, dense
HBM_BW = 3.35e12                # bytes/s, HBM3
NVLINK_BW_PER_CARD = 900e9      # bytes/s, NVLink 4, all 18 links of a card

MULTI_PROCESS_ITEM = ("ROADMAP queue 1 item 8b (tensor-parallel and FSDP "
                      "placement, pure FSDP, sharded event ops on their own "
                      "ranks, the multi-pod mesh, an MoE whose tokens a "
                      "data rank's rows cut)")
# What a one-process mesh over several distinct devices is told to use.
RANK_MESH_HINT = ("run one process a device over a process group instead: "
                  "launch.mesh.make_rank_mesh (launch.distributed.spawn or "
                  "torchrun)")


class Mesh:
    """A logical device mesh: `axis_names`, a `shape` mapping axis name to
    size, `devices` (an object array of `torch.device` of that shape, or
    None for an abstract mesh) and `size`, the number of positions."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[np.ndarray] = None):
        shape = tuple(int(n) for n in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match the axes "
                             f"{axis_names}")
        if devices is not None and tuple(devices.shape) != shape:
            raise ValueError(f"{devices.size} devices laid out as "
                             f"{devices.shape}, mesh shape {shape}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.devices = devices
        self.size = math.prod(shape)

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in position order."""
        if self.devices is None:
            return ()
        seen: list = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return tuple(seen)

    def shard_devices(self, axes: Sequence[str]) -> Tuple[torch.device, ...]:
        """One device per shard of the row axis split over `axes` (the
        other axes' first position), in shard order."""
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices to run on")
        index = [slice(None) if a in axes else 0 for a in self.axis_names]
        # Keep the named axes in mesh order, so the shard index runs over
        # them row-major, as the row split does.
        return tuple(self.devices[tuple(index)].flat)

    def __repr__(self) -> str:
        dev = ("abstract" if self.devices is None else
               ",".join(str(d) for d in self.distinct_devices()))
        return f"Mesh({self.shape}, {dev})"


def _as_devices(devices, n: int) -> list:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh on the card was requested but "
                "torch.cuda.is_available() is False; pass devices='cpu' "
                "for a mesh of CPU positions")
        found = torch.cuda.device_count()
        if found < n:
            raise RuntimeError(
                f"a mesh of {n} positions needs {n} cards, {found} visible; "
                f"pass devices= to repeat a device over positions")
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(devices, (str, torch.device)):
        from repro_torch import resolve_device
        return [resolve_device(devices)] * n
    devs = [torch.device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices for a mesh of {n} positions")
    return devs


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              devices=None) -> Mesh:
    """A mesh of `shape` over `axes`. `devices`: None takes the first
    prod(shape) visible cards (raising where there are fewer); one device
    (a `torch.device` or a string such as ``"cuda:0"`` or ``"cpu"``) is
    repeated at every position, a logical mesh; a sequence gives one
    device per position, in row-major order."""
    n = math.prod(int(x) for x in shape)
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(_as_devices(devices, n)):
        arr[i] = d
    return Mesh(shape, axes, arr.reshape(tuple(int(x) for x in shape)))


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh with no devices, for spec rules and their validation."""
    return Mesh(shape, axes, None)


def make_host_mesh(model: int = 1, *, device="cuda") -> Mesh:
    """A (data, model) mesh of the host's devices, one position each:
    ``device="cuda"`` covers every visible card, ``"cuda:i"`` that card
    alone, and ``"cpu"`` is the one-position CPU mesh the tests use. Where
    no card is visible and the card is asked for, it raises."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    n = len(devs)
    if n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    return make_mesh((n // model, model), ("data", "model"), devices=devs)


class RankMesh(Mesh):
    """A mesh whose positions are the ranks of the process group, one
    process each, in row-major order. `rank` and `device` are this
    process's; `devices` is None (a rank knows no other rank's device).
    `axis_group(axis)` is the sub-group of the ranks that share every
    other coordinate with this one."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int, device: torch.device, groups: Dict[str, object]):
        super().__init__(shape, axis_names, None)
        self.rank = rank
        self.device = device
        self._groups = groups

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> coordinate of `rank` (this rank by default)."""
        r = self.rank if rank is None else rank
        idx = np.unravel_index(r, tuple(self.shape.values()))
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def axis_group(self, axis: str):
        """The process group of the ranks along `axis` through this one."""
        return self._groups[axis]

    def shard_devices(self, axes: Sequence[str]):
        raise NotImplementedError(
            f"a rank mesh runs one shard a process; sharded event ops on "
            f"their own ranks are not ported yet ({MULTI_PROCESS_ITEM})")

    def __repr__(self) -> str:
        return f"RankMesh({self.shape}, rank {self.rank} on {self.device})"


def make_rank_mesh(shape: Sequence[int], axes: Sequence[str]) -> RankMesh:
    """The mesh of `shape` over `axes` whose positions are the ranks of the
    initialized process group (`launch.distributed.init`): prod(shape)
    must equal the world size. Every rank must call it, with the same
    arguments: each axis's sub-groups are created by every rank in the
    same order (`torch.distributed.new_group` is collective), or the
    ranks deadlock."""
    import torch.distributed as dist
    from repro_torch.launch import distributed
    if not distributed.is_initialized():
        raise RuntimeError("a rank mesh needs an initialized process group "
                           "(launch.distributed.init or spawn)")
    shape = tuple(int(n) for n in shape)
    axes = tuple(axes)
    world = distributed.world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks, the group has {world}")
    me = distributed.rank()
    grid = np.arange(world).reshape(shape)
    groups: Dict[str, object] = {}
    for i, axis in enumerate(axes):
        # Every line of ranks along `axis`, in one fixed order.
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks)
            if me in ranks:
                groups[axis] = g
    return RankMesh(shape, axes, me, distributed.device(), groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """With a process group initialized, the (data, model) rank mesh of
    its ranks, all on `data` (every rank must call it); otherwise the
    single-host (data, model) mesh over the visible cards. The
    reference's multi-pod (pod, data, model) mesh spans several hosts:
    it raises."""
    if multi_pod:
        raise NotImplementedError(
            f"a multi-pod mesh spans several hosts, which the port cannot "
            f"drive yet ({MULTI_PROCESS_ITEM})")
    from repro_torch.launch import distributed
    if distributed.is_initialized():
        return make_rank_mesh((distributed.world_size(), 1),
                              ("data", "model"))
    return make_host_mesh()


def refuse_distinct_devices(mesh: Mesh, what: str) -> None:
    """Raise where a one-process (logical) mesh spans several devices:
    `what` needs a rank mesh there."""
    if isinstance(mesh, RankMesh):
        return
    devices = mesh.distinct_devices()
    if len(devices) > 1:
        raise NotImplementedError(
            f"{what} over a one-process mesh of {len(devices)} devices is "
            f"not supported: {RANK_MESH_HINT}")


def use_concrete_mesh(mesh: Optional[Mesh]):
    """Install `mesh` as the ambient mesh for the block (None: no-op). The
    one stack is the registry's (`kernels.dispatch.use_mesh`), so
    resolution inside the block runs per data shard of `mesh`."""
    from repro_torch.kernels import dispatch
    return contextlib.nullcontext() if mesh is None \
        else dispatch.use_mesh(mesh)


def current_mesh() -> Optional[Mesh]:
    """The innermost ambient mesh (`dispatch.ambient_mesh`), or None."""
    from repro_torch.kernels import dispatch
    return dispatch.ambient_mesh()


def chips(mesh: Mesh) -> int:
    """Number of mesh positions (the reference counts one chip each)."""
    return mesh.size


def shard_map(f: Callable, *, mesh: Mesh, axes: Sequence[str],
              shard_args: Sequence[tuple] = ()) -> Callable:
    """Per-shard executor. Returns ``run(x, *rest)``: `x` is split along
    its leading axis into as many contiguous equal slices as the mesh has
    shards over `axes`, and `rest` is replicated. ``f(i, x_i, *rest,
    *shard_args[i])`` runs shard i on its position's device (arguments
    moved there, the result moved back to x's device), and the results
    are concatenated in shard order. `shard_args` carry per-shard
    operands that are already split (each shard's own work list)."""
    devices = mesh.shard_devices(tuple(axes))
    n = len(devices)

    def run(x, *rest):
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} does not split "
                             f"into {n} equal shards")
        per = x.shape[0] // n
        outs = []
        for i, dev in enumerate(devices):
            local = [a.to(dev) if isinstance(a, torch.Tensor) else a
                     for a in rest]
            extra = tuple(shard_args[i]) if shard_args else ()
            outs.append(f(i, x[i * per:(i + 1) * per].to(dev), *local,
                          *extra).to(x.device))
        return torch.cat(outs, dim=0)
    return run
