"""Runtime: the straggler and occupancy-skew signals, and the fault
injectors (the guard's event faults, the serve and checkpoint faults).
Sharding and elastic restart wait for ROADMAP queue 1 item 8's sharded
half."""
from . import faults, straggler
__all__ = ["faults", "straggler"]
