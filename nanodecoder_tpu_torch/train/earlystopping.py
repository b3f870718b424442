"""Early stopping on validation metrics (the port's copy of
`nanodecoder_tpu.train.earlystopping`): stop after `patience`
validations that do not improve the tracked metric by more than
`min_delta`."""

from __future__ import annotations

import dataclasses
import math

from nanodecoder_tpu_torch.utils.statistics import Statistics


@dataclasses.dataclass
class EarlyStopping:
    patience: int = 3
    metric: str = "xent"  # "xent" (lower better) | "accuracy" (higher better)
    min_delta: float = 0.0

    best: float = dataclasses.field(init=False)
    bad_count: int = dataclasses.field(default=0, init=False)
    stopped: bool = dataclasses.field(default=False, init=False)

    def __post_init__(self):
        self.best = math.inf if self.metric == "xent" else -math.inf

    def _value(self, stats: Statistics) -> float:
        if self.metric == "xent":
            return stats.xent
        if self.metric == "accuracy":
            return stats.accuracy
        raise ValueError(f"unknown early-stopping metric {self.metric!r}")

    def improved(self, value: float) -> bool:
        if self.metric == "xent":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def update(self, stats: Statistics) -> bool:
        """Record a validation; returns True when training should stop."""
        value = self._value(stats)
        if self.improved(value):
            self.best = value
            self.bad_count = 0
        else:
            self.bad_count += 1
            if self.bad_count >= self.patience:
                self.stopped = True
        return self.stopped
