"""Observability: statistics, reports (JSON lines, TensorBoard), per-stage
timers, the device trace, and logging (the port's counterpart of
`nanodecoder_tpu.utils`; the JAX package's compilation cache has its
counterpart in `build_cache`).

The JAX package's re-exports resolve on first use, so the host tier
takes `utils.logging` without torch."""

from nanodecoder_tpu_torch._lazy import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "Statistics": "statistics", "ThroughputMeter": "statistics",
    "ReportManager": "report", "StageTimer": "profiling", "get_logger": "logging",
})
