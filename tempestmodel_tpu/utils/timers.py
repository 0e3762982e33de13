"""Per-phase wall-clock timers with device synchronization.

JAX analog of the reference ``FunctionTimer`` RAII group timers
(``src/base/FunctionTimer.{h,cpp}``) and the end-of-run report
(``src/atm/Model.cpp:520-689``): named groups accumulate total time and
entry counts; ``report()`` prints mean/min/max per group.  Device work is
synchronized at scope exit so the numbers mean what they say under jit.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class FunctionTimerGroup:
    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = 0.0

    def add(self, dt: float):
        self.total += dt
        self.count += 1
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)


class Timers:
    """Named phase timers ("Loop", "HorizontalStep", "VerticalStepImplicit",
    "Communicate"-analogs...)."""

    def __init__(self, sync: bool = True):
        self.groups = defaultdict(FunctionTimerGroup)
        self.sync = sync

    @contextlib.contextmanager
    def time(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        yield
        if self.sync and sync_value is not None:
            jax.block_until_ready(sync_value)
        elif self.sync:
            # synchronize all outstanding device work
            jax.effects_barrier()
        self.groups[name].add(time.perf_counter() - t0)

    def report(self, printer=print):
        printer("TIME  NAME                         MEAN(us)       "
                "COUNT     MIN(us)     MAX(us)")
        for name in sorted(self.groups):
            g = self.groups[name]
            mean = g.total / max(g.count, 1) * 1e6
            printer(f"      {name:<26} {mean:12.1f} {g.count:11d} "
                    f"{g.min * 1e6:11.1f} {g.max * 1e6:11.1f}")

    def as_dict(self):
        return {k: {"total_s": g.total, "count": g.count}
                for k, g in self.groups.items()}
