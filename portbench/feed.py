"""Reads for the streaming engine, made in its own ingest processes.

The engine's ingest pool calls one function per signal file: it reads the
file, then normalizes, chunks and converts each read to the wire with the
program's own functions.  The card's machine has neither h5py nor the
pod5 codecs, and signal files for a window of reads would write
gigabytes a run, so the benchmark hands the engine descriptors in place
of file names and `ingest_descriptor` in place of the file read: it
simulates the descriptor's reads (`sim.ReadSource`) and then runs the
program's own normalization, chunking and wire conversion on them.
Nothing is written to disk.

`Feed` is the engine's list of files: an iterable of descriptors, each
`per_file` consecutive reads of the seed's stream, that stops giving new
ones once `stop()` is called and it has given `min_reads`; the engine then
finishes what it was given.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading

import numpy as np

from portbench.sim import ReadSource

_EMPTY = np.zeros((0,), np.float32)


def ingest_descriptor(path: str, scfg, h2d_name: str):
    """The program's per-file ingest (`io.pipeline._ingest_file_worker`)
    with the file read replaced by the simulator."""
    from nanodecoder_tpu_torch.io.fast5 import RawRead
    from nanodecoder_tpu_torch.io.pipeline import ReadChunks
    from nanodecoder_tpu_torch.io.signal import chunk_signal, convert_h2d, normalize_signal

    desc = json.loads(path)
    source = ReadSource(desc["seed"], desc["reads"])
    out = []
    for i in range(desc["first"], desc["first"] + desc["count"]):
        _truth, signal = source.read(i)
        norm = normalize_signal(signal, scfg.normalization, scfg.mad_scale, scfg.clip_sigma)
        cb = chunk_signal(norm, scfg.chunk_len, scfg.chunk_overlap, scfg.min_chunk_fill)
        cb = dataclasses.replace(cb, chunks=convert_h2d(cb.chunks, h2d_name, scfg.clip_sigma))
        out.append(ReadChunks(read=RawRead(read_id=ReadSource.read_id(i), signal=_EMPTY,
                                           source_file="sim"), chunks=cb))
    return out


@contextlib.contextmanager
def simulated_ingest():
    """The engine's ingest pool runs `ingest_descriptor` while inside."""
    from nanodecoder_tpu_torch.io import pipeline

    saved = pipeline._ingest_file_worker
    pipeline._ingest_file_worker = ingest_descriptor
    try:
        yield
    finally:
        pipeline._ingest_file_worker = saved


class Feed:
    """Descriptors of reads first, first + per_file, ... of a seed's
    stream, up to `limit` reads, or until `stop()` once `min_reads` are
    given."""

    def __init__(self, seed: int, reads: dict, limit: int | None = None, min_reads: int = 0):
        self.seed = int(seed)
        self.reads = reads
        self.per_file = int(reads["per_file"])
        self.limit = limit
        self.min_reads = min_reads
        self.given = 0
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def __iter__(self):
        while (not self._stop.is_set() or self.given < self.min_reads) and (
                self.limit is None or self.given < self.limit):
            count = self.per_file if self.limit is None else min(
                self.per_file, self.limit - self.given)
            desc = {"seed": self.seed, "reads": self.reads, "first": self.given,
                    "count": count}
            self.given += count
            yield json.dumps(desc)
