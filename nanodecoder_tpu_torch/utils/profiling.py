"""Per-stage wall-clock timers and the device trace (the port's
counterpart of `nanodecoder_tpu.utils.profiling`: `StageTimer`, and
`device_trace` on torch.profiler where the JAX package's runs
jax.profiler)."""

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


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Trace the enclosed work with torch.profiler (CPU activity, and CUDA
    where a card is present) into a Chrome trace under `log_dir`, written
    by `tensorboard_trace_handler` (a `*.pt.trace.json` file) when the
    block ends.  No-op for None.  Yields the profiler (None when off)."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
