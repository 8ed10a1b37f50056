"""Runtime: the straggler and occupancy-skew signals, and the serve and
checkpoint faults. Sharding, elastic restart and the rest of the fault
injectors wait for ROADMAP queue 1 item 8."""
from . import faults, straggler
__all__ = ["faults", "straggler"]
