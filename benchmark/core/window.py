"""The measured window: a fixed number of whole units, back to back.

A run's work is fixed before the window opens, so that two runs of one
seed do the same work whatever the host's speed: the window holds
``units_for(seconds, unit_s)`` units, as many as fit into ``--seconds``
at the nominal wall ``unit_s`` that the traffic mix states for a unit on
the card (at least one).  The window ends when its last unit ends, and
its rate is all the work of its units over all of that wall (no median
of units).
"""

import dataclasses
import math
import time


@dataclasses.dataclass
class Window:
    start: float
    end: float
    walls: list           # seconds per unit
    units: list           # what each unit returned

    @property
    def wall(self) -> float:
        return self.end - self.start


def units_for(seconds, unit_s) -> int:
    """Units of nominal wall ``unit_s`` that fit into ``seconds``."""
    return max(1, math.floor(seconds / unit_s + 1e-9))


def run(next_unit, n_units, clock=time.perf_counter):
    """Call ``next_unit(k)`` for ``k = 0 .. n_units - 1``; it returns None
    when it has no more work, which ends the window early."""
    start = clock()
    walls, units = [], []
    for k in range(n_units):
        t0 = clock()
        out = next_unit(k)
        if out is None:
            break
        walls.append(clock() - t0)
        units.append(out)
    return Window(start, clock(), walls, units)
