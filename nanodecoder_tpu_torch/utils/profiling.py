"""Per-stage wall-clock timers (the port's copy of
`nanodecoder_tpu.utils.profiling.StageTimer`; its `device_trace`, a
jax.profiler hook, has no counterpart here yet)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimer:
    """Accumulating named wall-clock timers.

    with timer.stage("decode"): ...
    timer.summary() -> {"decode": {"total_sec": ..., "count": ...}, ...}
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_sec": self.totals[name],
                "count": self.counts[name],
                "mean_sec": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
