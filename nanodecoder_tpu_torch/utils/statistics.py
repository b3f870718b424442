"""Training and inference statistics accumulators (the port's copy of
`nanodecoder_tpu.utils.statistics`): accuracy, perplexity, cross-entropy
and tokens/s for training; basecalled samples/s, reads/s and bases/s for
inference.
"""

from __future__ import annotations

import dataclasses
import math
import time


@dataclasses.dataclass
class Statistics:
    """Accumulates loss/accuracy over (micro)batches."""

    loss: float = 0.0
    n_tokens: int = 0
    n_correct: int = 0
    n_batches: int = 0
    start_time: float = dataclasses.field(default_factory=time.perf_counter)

    def update(self, loss: float, n_tokens: int, n_correct: int) -> None:
        self.loss += float(loss)
        self.n_tokens += int(n_tokens)
        self.n_correct += int(n_correct)
        self.n_batches += 1

    @property
    def accuracy(self) -> float:
        return self.n_correct / self.n_tokens if self.n_tokens else 0.0

    @property
    def xent(self) -> float:
        return self.loss / self.n_tokens if self.n_tokens else 0.0

    @property
    def ppl(self) -> float:
        return math.exp(min(self.xent, 100.0))

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.start_time

    @property
    def tokens_per_sec(self) -> float:
        el = self.elapsed
        return self.n_tokens / el if el > 0 else 0.0

    def reset(self) -> None:
        self.loss = 0.0
        self.n_tokens = 0
        self.n_correct = 0
        self.n_batches = 0
        self.start_time = time.perf_counter()


@dataclasses.dataclass
class ThroughputMeter:
    """Inference throughput: samples/s (raw signal samples), reads/s,
    bases/s."""

    n_samples: int = 0
    n_reads: int = 0
    n_bases: int = 0
    n_chunks: int = 0
    start_time: float = dataclasses.field(default_factory=time.perf_counter)

    def update(self, n_samples: int, n_bases: int, n_chunks: int, n_reads: int = 1) -> None:
        self.n_samples += n_samples
        self.n_bases += n_bases
        self.n_chunks += n_chunks
        self.n_reads += n_reads

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.start_time

    def rates(self) -> dict[str, float]:
        el = max(self.elapsed, 1e-9)
        return {
            "samples_per_sec": self.n_samples / el,
            "ksamples_per_sec": self.n_samples / el / 1e3,
            "reads_per_sec": self.n_reads / el,
            "bases_per_sec": self.n_bases / el,
            "chunks_per_sec": self.n_chunks / el,
            "elapsed_sec": el,
        }
