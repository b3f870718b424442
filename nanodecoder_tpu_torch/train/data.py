"""Training data: the synthetic nanopore signal simulator and the batch
streams (the port's numpy copy of `nanodecoder_tpu.train.data`; for the
same seed every function returns the same bytes as the JAX package's).

Each base emits a Gamma-distributed dwell of samples at a 3-mer
context-dependent current level plus Gaussian noise.  A training example
is a `chunk_len` window of a simulated read with the bases whose dwell
midpoint falls inside it as targets; batches are dicts of numpy arrays,
(A, B, ...) with the accumulation axis or (B, ...) without.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
from typing import Iterator

import numpy as np

from nanodecoder_tpu_torch.config import Config
from nanodecoder_tpu_torch.io.signal import normalize_signal
from nanodecoder_tpu_torch.utils.profiling import span
from nanodecoder_tpu_torch.vocab import BOS_ID, EOS_ID, PAD_ID, make_vocab


def pack_targets(ids: np.ndarray, tmax: int) -> tuple[np.ndarray, np.ndarray]:
    """Token ids -> the teacher-forcing pair (tgt_in = BOS + ids, tgt_out =
    ids + EOS), both PAD-padded to tmax; ids hold at most tmax - 1 tokens."""
    if ids.shape[0] > tmax - 1:
        raise ValueError(f"{ids.shape[0]} ids leave no room for EOS in {tmax}")
    tgt_in = np.full(tmax, PAD_ID, np.int32)
    tgt_out = np.full(tmax, PAD_ID, np.int32)
    n = ids.shape[0]
    tgt_in[0] = BOS_ID
    tgt_in[1:n + 1] = ids
    tgt_out[:n] = ids
    tgt_out[n] = EOS_ID
    return tgt_in, tgt_out

@dataclasses.dataclass
class SimSpec:
    """Nanopore-ish signal model: 3-mer context current levels."""

    mean_dwell: float = 9.0      # samples per base
    dwell_shape: float = 3.0     # gamma shape (dwell jitter)
    noise_sigma: float = 0.25    # gaussian current noise
    context: int = 3             # k-mer size driving the level table
    seed: int = 1234

    def level_table(self) -> np.ndarray:
        """(4**context,) current levels in 'normalized pA', fixed by seed."""
        rng = np.random.default_rng(self.seed)
        return rng.normal(0.0, 1.0, size=4 ** self.context).astype(np.float32)


def simulate_read_with_dwells(
    rng: np.random.Generator,
    n_bases: int,
    spec: SimSpec,
    levels: np.ndarray | None = None,
) -> tuple[str, np.ndarray, np.ndarray]:
    """Random DNA -> (sequence, float32 signal, per-base dwell counts)."""
    if levels is None:
        levels = spec.level_table()
    bases = rng.integers(0, 4, size=n_bases)
    k = spec.context
    # Context index of base i: bases[i-k+1..i] as a base-4 number (edges clamp).
    padded = np.concatenate([np.full(k - 1, bases[0]), bases])
    ctx_idx = np.zeros(n_bases, np.int64)
    for j in range(k):
        ctx_idx = ctx_idx * 4 + padded[j : j + n_bases]
    dwells = np.maximum(
        rng.gamma(spec.dwell_shape, spec.mean_dwell / spec.dwell_shape, size=n_bases),
        1.0,
    ).astype(np.int64)
    sig = np.repeat(levels[ctx_idx], dwells)
    sig = sig + rng.normal(0.0, spec.noise_sigma, size=sig.shape[0]).astype(np.float32)
    seq = "".join("ACGT"[b] for b in bases)
    return seq, sig.astype(np.float32), dwells


def simulate_read(
    rng: np.random.Generator,
    n_bases: int,
    spec: SimSpec,
    levels: np.ndarray | None = None,
) -> tuple[str, np.ndarray]:
    """Random DNA -> (sequence, float32 signal) under the simulator."""
    seq, sig, _ = simulate_read_with_dwells(rng, n_bases, spec, levels)
    return seq, sig


def make_example(rng: np.random.Generator, config: Config, spec: SimSpec,
                 levels: np.ndarray) -> dict[str, np.ndarray]:
    """One (signal chunk, target) pair with static shapes: a window of
    chunk_len samples (one in ten a shorter, zero-padded window) cut from
    a longer simulated read, normalized; targets are the bases whose dwell
    midpoint lies in the window, tokenized by the configured k-mer vocab
    and truncated to max_decode_len - 1 tokens.
    signal (chunk_len,) f32, sig_lengths () i32, tgt_in and tgt_out (T,) i32."""
    scfg, mcfg = config.signal, config.model
    tmax, clen = mcfg.max_decode_len, scfg.chunk_len
    short = rng.random() < 0.1
    window = int(rng.integers(clen // 8, clen)) if short else clen
    n_bases = int(window / spec.mean_dwell * 1.6) + 8
    seq, sig, dwells = simulate_read_with_dwells(rng, n_bases, spec, levels)
    start = int(rng.integers(0, max(sig.shape[0] - window, 0) + 1))
    sig = sig[start:start + window]
    n = sig.shape[0]
    ends = np.cumsum(dwells)
    mids = ends - dwells / 2.0
    sel = (mids >= start) & (mids < start + n)
    label = "".join(c for c, m in zip(seq, sel) if m)
    signal = np.zeros(clen, np.float32)
    signal[:n] = normalize_signal(sig, scfg.normalization, scfg.mad_scale,
                                  scfg.clip_sigma)
    ids = make_vocab(mcfg.kmer_k).encode(label)[:tmax - 1]
    tgt_in, tgt_out = pack_targets(ids, tmax)
    return {"signal": signal, "sig_lengths": np.int32(n), "tgt_in": tgt_in,
            "tgt_out": tgt_out}


def synthetic_batches(config: Config, spec: SimSpec | None = None, seed: int = 0,
                      accum_axis: bool = True) -> Iterator[dict[str, np.ndarray]]:
    """Endless batches of simulated examples: (A, B, ...) when accum_axis,
    else (B, ...)."""
    spec = spec or SimSpec()
    levels = spec.level_table()
    rng = np.random.default_rng(seed)
    a, b = config.train.accum_steps, config.train.batch_size
    count = a * b if accum_axis else b
    while True:
        exs = [make_example(rng, config, spec, levels) for _ in range(count)]
        batch = {k: np.stack([e[k] for e in exs]) for k in exs[0]}
        if accum_axis:
            batch = {k: v.reshape((a, b) + v.shape[1:]) for k, v in batch.items()}
        yield batch


def _put_until(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Bounded put that gives up once the consumer has stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


def prefetch_batches(it: Iterator[dict[str, np.ndarray]], depth: int = 4
                     ) -> Iterator[dict[str, np.ndarray]]:
    """The batches of `it`, in order, made ahead by one daemon thread into
    a queue of `depth`.  An error of the source is raised in the consumer
    (not turned into the end of the stream); the thread stops when the
    consumer does.  The consumer's waits are `train.data_wait` spans, the
    step number counting the batches taken, while the span recorder of
    utils/profiling.py is on."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def producer() -> None:
        try:
            for batch in it:
                if not _put_until(q, batch, stop):
                    return
            _put_until(q, done, stop)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            _put_until(q, e, stop)

    threading.Thread(target=producer, daemon=True, name="batch-prefetch").start()
    try:
        for n in itertools.count():
            with span("train.data_wait", step=n):
                batch = q.get()
            if batch is done:
                return
            if isinstance(batch, BaseException):
                raise batch
            yield batch
    finally:
        stop.set()


def interleave_batches(config: Config, seeds: tuple[int, ...],
                       spec: SimSpec | None = None, accum_axis: bool = True,
                       depth: int = 2) -> Iterator[dict[str, np.ndarray]]:
    """One simulator thread per seed, their batches interleaved through one
    bounded queue: each stream is that of synthetic_batches(seed), the
    order between streams is not fixed.  A worker's error is raised in
    the consumer."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, len(seeds)))
    stop = threading.Event()

    def worker(seed: int) -> None:
        try:
            for batch in synthetic_batches(config, spec=spec, seed=seed,
                                           accum_axis=accum_axis):
                if not _put_until(q, batch, stop):
                    return
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            _put_until(q, e, stop)

    threads = [threading.Thread(target=worker, args=(s,), daemon=True, name=f"sim-{s}")
               for s in seeds]
    for t in threads:
        t.start()
    try:
        while True:
            try:
                item = q.get(timeout=5.0)
            except queue.Empty:
                if not any(t.is_alive() for t in threads):
                    raise RuntimeError("all interleave_batches workers died without "
                                       "reporting an error") from None
                continue
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def synthetic_valid_batches(config: Config, n_batches: int = 4, seed: int = 999,
                            spec: SimSpec | None = None) -> list[dict[str, np.ndarray]]:
    """A fixed list of (B, ...) validation batches."""
    it = synthetic_batches(config, spec=spec, seed=seed, accum_axis=False)
    return [next(it) for _ in range(n_batches)]
