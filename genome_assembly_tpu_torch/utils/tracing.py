"""Structured stage timing.

- `stage(name)` — context-manager stage timer feeding a global registry;
- `Tracer` — per-run collector with an item-throughput counter and a
  report() string.

Stage times are host wall-clock. A stage that ends in a copy to the host
(``score.pairs`` ends in one) includes the device work it waited for.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Tracer:
    """Collects stage wall-times and item-throughput counters."""

    times: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    items: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self.times[name] += dt
            self.counts[name] += 1
            self.items[name] += items

    def throughput(self, name: str) -> float:
        """items/sec for a stage (0.0 when unmeasured)."""
        t = self.times.get(name, 0.0)
        return self.items.get(name, 0) / t if t > 0 else 0.0

    def report(self) -> str:
        lines = []
        for name in self.times:
            line = (f"{name:30s} {self.times[name]:9.3f}s "
                    f"x{self.counts[name]}")
            if self.items[name]:
                line += (f"  {self.items[name]:>12,d} items "
                         f"({self.throughput(name):,.0f}/s)")
            lines.append(line)
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            name: {"seconds": self.times[name], "calls": self.counts[name],
                   "items": self.items[name],
                   "per_sec": self.throughput(name)}
            for name in self.times
        }

    def reset(self) -> None:
        self.times.clear()
        self.counts.clear()
        self.items.clear()


_GLOBAL = Tracer()


def global_tracer() -> Tracer:
    return _GLOBAL


@contextlib.contextmanager
def stage(name: str, items: int = 0):
    """Module-level stage timer on the global tracer."""
    with _GLOBAL.stage(name, items=items):
        yield _GLOBAL
