"""Elastic restart onto a smaller mesh after a data-shard group is lost,
the port of `repro.runtime.elastic`.

The checkpoint stores logical (unsharded) values, so `reshard_restore`
restores the newest valid snapshot (walking back past a torn one, as
`CheckpointManager.restore_latest` does) for the new mesh: its specs are
computed and validated against that mesh, and the tree is restored onto
the mesh's device. `shrunk_mesh` computes the largest valid mesh once
hosts have failed: the `model` axis is kept (tensor-parallel
divisibility) and the `data` axis shrinks, so the global batch per step
is kept by raising the microbatch count (the plan's `microbatch_scale`).
This recovers the `dropped_shard` fault class (`runtime.faults`).

Onto a rank mesh (`launch.mesh.RankMesh`) every rank restores the same
snapshot (`CheckpointManager.restore_latest(group=)`) onto its own
device, each leaf cut to the rank's part of it as it is read
(`sharding.leaf_cuts`), so no whole expert bank reaches the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import LMConfig
from repro_torch.launch.mesh import Mesh, RankMesh, refuse_distinct_devices
from . import sharding


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    microbatch_scale: int      # multiply cfg.microbatches by this


def shrunk_mesh(old_shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                n_failed_data_groups: int) -> ElasticPlan:
    """Drop `n_failed_data_groups` rows from the data axis; keep model."""
    shape = list(old_shape)
    data_idx = axis_names.index("data")
    old_data = shape[data_idx]
    new_data = old_data - n_failed_data_groups
    # keep the data axis a divisor of the old one (batch divisibility)
    while new_data > 1 and old_data % new_data:
        new_data -= 1
    if new_data < 1:
        raise RuntimeError("no healthy data groups left")
    shape[data_idx] = new_data
    return ElasticPlan(tuple(shape), axis_names,
                       microbatch_scale=old_data // new_data)


def reshard_restore(cfg: LMConfig, mgr: CheckpointManager,
                    target_tree: Any, new_mesh: Mesh,
                    ) -> Tuple[Optional[int], Any]:
    """Restore the newest valid checkpoint for `new_mesh` (another shape
    than the one that saved it is fine): (step, tree), or (None,
    target_tree) when no snapshot is valid. The param specs of the new
    mesh are computed and validated; the tree is restored onto the
    mesh's device. On a rank mesh every rank calls this: all restore the
    same step, each onto its own device, and keep their `local_params`
    part of it. The target tree is the whole one, and its leaves give
    shapes alone (`meta` tensors will do). A one-process mesh over
    several devices raises, naming the rank mesh."""
    refuse_distinct_devices(new_mesh, "restoring")
    pair = isinstance(target_tree, tuple) and not hasattr(target_tree,
                                                          "_fields")
    params = target_tree[0] if pair else target_tree
    specs = sharding.param_specs(cfg, params, new_mesh)
    problems = sharding.validate_specs(params, specs, new_mesh)
    if problems:
        raise ValueError(f"param specs do not fit {new_mesh}: "
                         f"{problems[:3]}")
    if not isinstance(new_mesh, RankMesh):
        return mgr.restore_latest(target_tree,
                                  new_mesh.distinct_devices()[0])
    import torch.distributed as dist
    tree_specs = sharding.state_specs(specs) if pair else specs
    return mgr.restore_latest(
        target_tree, new_mesh.device, group=dist.group.WORLD,
        cuts=sharding.leaf_cuts(target_tree, tree_specs, new_mesh))
