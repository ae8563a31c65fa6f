"""Wall-clock timing utilities (twin of photobundle_tpu/utils/timer.py):
the reference's RAII `Timer` / `TimeCode` macros (pb:src/timer.h) as
context managers, plus aggregate counters for per-phase reports."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class Timer:
    """Accumulating named timers: Timer.time('phase') context manager."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.totals[name] / c if c else 0.0

    def report(self) -> str:
        lines = ["phase                          total(s)   count   mean(ms)"]
        for name in sorted(self.totals):
            lines.append(
                f"{name:<30} {self.totals[name]:>8.3f} {self.counts[name]:>7d} "
                f"{1e3 * self.mean(name):>10.2f}"
            )
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return {k: self.totals[k] for k in self.totals}


@contextmanager
def time_code(label: str, printer=print):
    """One-shot timer, mirrors the reference's TimeCode(...) macro."""
    t0 = time.perf_counter()
    yield
    printer(f"[timer] {label}: {1e3 * (time.perf_counter() - t0):.2f} ms")
