"""Training reports and structured JSON metrics (the port's copy of
`nanodecoder_tpu.utils.report`): periodic log lines, and one JSON record
per report appended to `metrics_path` when it is given, and TensorBoard
scalars (`kind/key` at the record's step) in `tensorboard_dir` when it is
given and `torch.utils.tensorboard` imports (else one warning, and no
TensorBoard sink).  The basecall CLI emits its inference record through
`report_inference`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from nanodecoder_tpu_torch.utils.logging import get_logger
from nanodecoder_tpu_torch.utils.statistics import Statistics


class ReportManager:
    def __init__(self, report_every: int = 50, metrics_path: str | None = None,
                 tensorboard_dir: str | None = None):
        self.report_every = report_every
        self.metrics_path = metrics_path
        self.log = get_logger("train")
        if metrics_path:
            parent = os.path.dirname(os.path.abspath(metrics_path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(metrics_path, "a")
        else:
            self._fh = None
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:  # the tensorboard package is optional
                self.log.warning("tensorboard requested but unavailable (%s); "
                                 "skipping it", e)
            else:
                self._tb = SummaryWriter(log_dir=tensorboard_dir)

    def _emit(self, record: dict[str, Any]) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self._tb is not None and "step" in record:
            kind = record.get("kind", "train")
            for key, val in record.items():
                if key not in ("kind", "step", "time") and isinstance(val, (int, float)):
                    self._tb.add_scalar(f"{kind}/{key}", val, record["step"])

    def report_training(self, step: int, stats: Statistics, lr: float) -> None:
        if step % self.report_every != 0:
            return
        self.log.info(
            "step %6d | acc %6.2f%% | ppl %8.2f | xent %6.4f | lr %.2e | %6.0f tok/s",
            step, 100 * stats.accuracy, stats.ppl, stats.xent, lr, stats.tokens_per_sec,
        )
        self._emit(
            {
                "kind": "train", "step": step, "time": time.time(),
                "accuracy": stats.accuracy, "ppl": stats.ppl, "xent": stats.xent,
                "lr": lr, "tokens_per_sec": stats.tokens_per_sec,
            }
        )
        stats.reset()

    def report_validation(self, step: int, stats: Statistics) -> None:
        self.log.info(
            "validation @ step %d | acc %6.2f%% | ppl %8.2f | xent %6.4f",
            step, 100 * stats.accuracy, stats.ppl, stats.xent,
        )
        self._emit(
            {
                "kind": "valid", "step": step, "time": time.time(),
                "accuracy": stats.accuracy, "ppl": stats.ppl, "xent": stats.xent,
            }
        )

    def report_inference(self, rates: dict[str, float], extra: dict[str, Any] | None = None) -> None:
        self.log.info(
            "basecall | %8.1f ksamples/s | %6.2f reads/s | %8.0f bases/s",
            rates.get("ksamples_per_sec", 0.0),
            rates.get("reads_per_sec", 0.0),
            rates.get("bases_per_sec", 0.0),
        )
        rec = {"kind": "inference", "time": time.time(), **rates}
        if extra:
            rec.update(extra)
        self._emit(rec)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
