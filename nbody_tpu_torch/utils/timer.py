"""Wall-clock timer, the CPUTime analog (ver0/cpu_time.hpp:30-48).

The reference reads gettimeofday as a float-seconds double with start()/stop()
both returning the current time; durations are differences.  We use the
monotonic ``perf_counter`` for the same interface.  The caller
synchronises the device before reading it (the engine does so by fetching
each sample block's kinetic energy)."""

from __future__ import annotations

import time


class WallTime:
    def start(self) -> float:
        return time.perf_counter()

    def stop(self) -> float:
        return time.perf_counter()
