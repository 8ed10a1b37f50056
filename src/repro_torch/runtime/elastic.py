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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import LMConfig
from repro_torch.launch.mesh import MULTI_PROCESS_ITEM, Mesh
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
    mesh's device. A mesh over several cards raises: placing shards on
    them is `MULTI_PROCESS_ITEM`."""
    devices = new_mesh.distinct_devices()
    if len(devices) != 1:
        raise NotImplementedError(
            f"restoring onto a mesh over {len(devices)} devices needs "
            f"multi-card placement ({MULTI_PROCESS_ITEM})")
    params = target_tree[0] if isinstance(target_tree, tuple) \
        else target_tree
    specs = sharding.param_specs(cfg, params, new_mesh)
    problems = sharding.validate_specs(params, specs, new_mesh)
    if problems:
        raise ValueError(f"param specs do not fit {new_mesh}: "
                         f"{problems[:3]}")
    return mgr.restore_latest(target_tree, devices[0])
