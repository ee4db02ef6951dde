"""Structured stage timing and profiling.

- `stage(name)` — context-manager stage timer feeding a global registry;
- `Tracer` — per-run collector with an item-throughput counter and a
  report() string;
- `profile(path)` — torch.profiler trace of a block, written as a Chrome
  trace.

Stage times are host wall-clock. A stage that ends in a copy to the host
(``score.pairs`` ends in one) includes the device work it waited for.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


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


@contextlib.contextmanager
def profile(path: str | None = None, enabled: bool = True):
    """Trace the block with ``torch.profiler``: CPU activity, and the card's
    kernels and copies when a card is present. On exit the trace is written
    as ``path``/trace.json (Chrome trace format; chrome://tracing or
    Perfetto), ``path`` defaulting to ga_tpu_trace in the temporary
    directory. Yields the profiler. With ``enabled=False`` it does
    nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    if path is None:
        path = os.path.join(tempfile.gettempdir(), "ga_tpu_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = torch_profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(path, exist_ok=True)
        prof.export_chrome_trace(os.path.join(path, "trace.json"))
