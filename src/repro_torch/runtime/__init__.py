"""Runtime: the straggler and occupancy-skew signals, the fault injectors
(the guard's event faults, the serve and checkpoint faults), the
sharding rules, the placement of every leaf on a mesh of ranks and
sharded event execution (`sharding`) and elastic restart onto a smaller
mesh (`elastic`), onto a mesh of ranks too. What is left of placement
across cards is `launch.mesh.MULTI_PROCESS_ITEM`."""
from . import elastic, faults, sharding, straggler
__all__ = ["elastic", "faults", "sharding", "straggler"]
