"""Streaming ingest: signal files -> normalized chunk batches (the port's
copy of `nanodecoder_tpu.io.pipeline`).

    ingest pool (file read, normalize, chunk, H2D wire conversion)
        -> bounded queue of per-read chunk work
        -> batcher packing chunks from MANY reads into fixed-shape
           (batch_chunks, wire columns) batches
        -> consumer (the streaming engine).

One producer thread, one bounded queue, clean shutdown by sentinels and
a stop event.  The ingest pool is a process pool started from a
forkserver: its workers fork from a clean server process, never from
the (threaded, CUDA-holding) parent.  They import torch on the CPU
through io/signal and never touch the card.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from nanodecoder_tpu_torch.config import SignalConfig
from nanodecoder_tpu_torch.io.fast5 import RawRead, list_signal_files, read_fast5_file
from nanodecoder_tpu_torch.io.signal import (_PACKED_WIRES, ChunkBatch, chunk_signal,
                                             convert_h2d, normalize_signal, wire_columns,
                                             wire_np_dtype)
from nanodecoder_tpu_torch.utils.logging import get_logger

log = get_logger("pipeline")


@dataclasses.dataclass
class ReadChunks:
    """A read's chunks, queued for decoding."""

    read: RawRead
    chunks: ChunkBatch


@dataclasses.dataclass
class PackedBatch:
    """Fixed-shape batch of chunks drawn from >=1 reads.

    sources[i] = (read_index, chunk_index) for row i; rows beyond
    `n_real` are padding.
    """

    chunks: np.ndarray    # (batch_chunks, wire columns) in the wire dtype
    lengths: np.ndarray   # (batch_chunks,) i32
    sources: list[tuple[int, int]]
    n_real: int


_SENTINEL = object()
_EMPTY_SIGNAL = np.zeros((0,), np.float32)


def _ingest_file_worker(path: str, scfg: SignalConfig, h2d_name: str):
    """Full per-file ingest, run in a worker process (process ingest):
    the file read, per-read normalization, chunking and the H2D wire
    conversion all happen outside the parent's GIL (in threads, the file
    library's lock and numpy's small-array work hold it).  The returned
    reads carry an EMPTY signal array: the raw signal is dead weight
    after chunking (sample counts live in ChunkBatch.total_samples), so
    only the converted chunks cross the process pipe."""
    out = []
    for read in read_fast5_file(path):
        norm = normalize_signal(read.signal, scfg.normalization,
                                scfg.mad_scale, scfg.clip_sigma)
        cb = chunk_signal(norm, scfg.chunk_len, scfg.chunk_overlap,
                          scfg.min_chunk_fill)
        cb = dataclasses.replace(
            cb, chunks=convert_h2d(cb.chunks, h2d_name, scfg.clip_sigma))
        slim = RawRead(read_id=read.read_id, signal=_EMPTY_SIGNAL,
                       source_file=read.source_file)
        out.append(ReadChunks(read=slim, chunks=cb))
    return out


_INGEST_POOL = None
_INGEST_POOL_WORKERS = 0
_INGEST_POOL_LOCK = threading.Lock()


def _get_ingest_pool(num_workers: int):
    """Process-global persistent ingest pool (forkserver context).

    forkserver: worker processes fork from a clean single-threaded
    server, never from this multi-threaded parent that holds a CUDA
    context.  The server preloads this module so each worker starts warm
    (one forkserver serves a process: where another pool started it
    first, its preload stands, and the workers import what they unpickle
    by module path).  The pool is grown (never shrunk) to the largest
    worker count requested and reused across pipelines and runs; the
    streaming engine runs its per-read finishing in it too."""
    global _INGEST_POOL, _INGEST_POOL_WORKERS
    with _INGEST_POOL_LOCK:
        if _INGEST_POOL is None or _INGEST_POOL_WORKERS < num_workers:
            from concurrent.futures import ProcessPoolExecutor

            ctx = multiprocessing.get_context("forkserver")
            ctx.set_forkserver_preload(["nanodecoder_tpu_torch.io.pipeline"])
            old = _INGEST_POOL
            _INGEST_POOL = ProcessPoolExecutor(max_workers=num_workers,
                                               mp_context=ctx)
            _INGEST_POOL_WORKERS = num_workers
            if old is not None:
                old.shutdown(wait=False, cancel_futures=True)
            else:
                import atexit

                atexit.register(
                    lambda: _INGEST_POOL and _INGEST_POOL.shutdown(
                        wait=False, cancel_futures=True))
    return _INGEST_POOL


def shutdown_ingest_pool() -> None:
    """Stop the process-global ingest pool and wait for its workers (a
    later pipeline starts a new one)."""
    global _INGEST_POOL, _INGEST_POOL_WORKERS
    with _INGEST_POOL_LOCK:
        pool, _INGEST_POOL, _INGEST_POOL_WORKERS = _INGEST_POOL, None, 0
    if pool is not None:
        pool.shutdown(wait=True, cancel_futures=True)


def stop_ingest_processes() -> None:
    """Stop the ingest pool, then the forkserver and the resource tracker
    that multiprocessing started for it, waiting for each to exit.

    For the end of a program: left alone, the server and the tracker exit
    only once they see this process's pipes close, a moment after it has
    ended.  Every other process pool of this process must be shut down
    first (the tracker exits only when no process holds its pipe)."""
    import gc
    from multiprocessing import forkserver, resource_tracker

    shutdown_ingest_pool()
    # The pool's queue semaphores unregister from the tracker when they are
    # collected; collect them now, or unregistering would start a new
    # tracker at exit.
    gc.collect()
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


class AsyncChunkPipeline:
    """files -> (ReadChunks stream, packed fixed-shape batches).

    Usage:
        pipe = AsyncChunkPipeline(files, signal_cfg, batch_chunks=32)
        for packed in pipe.batches():  # fixed-shape, ready for the card
            ...
        reads = pipe.reads  # index -> RawRead/ChunkBatch bookkeeping
    """

    def __init__(
        self,
        files: list[str],
        scfg: SignalConfig,
        batch_chunks: int,
        num_workers: int = 4,
        queue_depth: int = 64,
        h2d_dtype=np.float32,
        ingest: str = "process",
    ):
        """`h2d_dtype`: the wire of the packed batch arrays: a numpy
        dtype name (float32, float16, int8) or a packed sub-byte wire
        ("int4", "int6": uint8 arrays of chunk_len/2 + 4 or
        3*chunk_len/4 + 4 columns, per-chunk scale in the trailing bytes;
        io.signal).

        `ingest`: "process" (default) runs per-file ingest in the
        process pool (see _ingest_file_worker); "thread" keeps an
        in-process thread pool (no pickling)."""
        self.files = files
        self.scfg = scfg
        self.h2d_name = str(h2d_dtype) if str(h2d_dtype) in _PACKED_WIRES \
            else np.dtype(h2d_dtype).name
        self.h2d_dtype = wire_np_dtype(self.h2d_name)
        self.wire_cols = wire_columns(scfg.chunk_len, self.h2d_name)
        self.batch_chunks = batch_chunks
        self.num_workers = num_workers
        if ingest not in ("process", "thread"):
            raise ValueError(f"unknown ingest mode {ingest!r}")
        self.ingest = ingest
        # 64 reads hold about 2.4 batches at batch_chunks=512 (a read of
        # ~19 chunks), so the consumer finds one batch ahead.
        self.read_queue: queue.Queue = queue.Queue(maxsize=queue_depth)
        self.reads: list[ReadChunks] = []
        self._stop = threading.Event()
        self._producer_thread: threading.Thread | None = None

    # --- producer --------------------------------------------------------

    def _process_file(self, path: str) -> list[ReadChunks]:
        out = []
        for read in read_fast5_file(path):
            norm = normalize_signal(
                read.signal, self.scfg.normalization, self.scfg.mad_scale,
                self.scfg.clip_sigma,
            )
            cb = chunk_signal(norm, self.scfg.chunk_len, self.scfg.chunk_overlap,
                              self.scfg.min_chunk_fill)
            out.append(ReadChunks(read=read, chunks=cb))
        return out

    def _put(self, item) -> bool:
        """Blocking put that aborts when stop() is requested: a plain
        put() can deadlock, since the consumer may stop and drain ONCE
        while worker results are still arriving, after which the producer
        would block forever on the refilled bounded queue."""
        while not self._stop.is_set():
            try:
                self.read_queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        try:
            if self.ingest == "process":
                self._producer_process_pool()
            else:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for result in pool.map(self._process_file, self.files):
                        for rc in result:
                            if not self._put(rc):
                                return
        except Exception as e:  # surface ingest errors to the consumer
            log.error("ingest failed: %s", e)
            self._put(e)
        finally:
            self._put(_SENTINEL)

    def _producer_process_pool(self) -> None:
        """Process-pool ingest: at most 2 * workers files in flight,
        results consumed in submission order (file order, as in thread
        mode)."""
        import collections as _collections

        h2d_name = self.h2d_name
        pool = _get_ingest_pool(self.num_workers)
        futs: _collections.deque = _collections.deque()
        it = iter(self.files)

        def submit_next() -> None:
            path = next(it, None)
            if path is not None:
                futs.append(pool.submit(_ingest_file_worker, path,
                                        self.scfg, h2d_name))

        for _ in range(2 * self.num_workers):
            submit_next()
        while futs and not self._stop.is_set():
            result = futs.popleft().result()
            submit_next()
            for rc in result:
                if not self._put(rc):
                    return

    def start(self) -> "AsyncChunkPipeline":
        self._producer_thread = threading.Thread(target=self._producer, daemon=True)
        self._producer_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # Drain so the producer isn't blocked on a full queue.
        try:
            while True:
                self.read_queue.get_nowait()
        except queue.Empty:
            pass

    # --- consumer --------------------------------------------------------

    def read_stream(self) -> Iterator[ReadChunks]:
        """Yield reads in ingest order, recording them in self.reads."""
        if self._producer_thread is None:
            self.start()
        while True:
            item = self.read_queue.get()
            if item is _SENTINEL:
                return
            if isinstance(item, Exception):
                raise item
            self.reads.append(item)
            yield item

    def batches(self) -> Iterator[PackedBatch]:
        """Pack the chunk streams of consecutive reads into fixed-shape
        batches; the final partial batch is zero-padded."""
        bsz = self.batch_chunks
        buf_chunks: list[np.ndarray] = []
        buf_lens: list[int] = []
        buf_src: list[tuple[int, int]] = []

        def flush() -> PackedBatch:
            n_real = len(buf_chunks)
            chunks = np.zeros((bsz, self.wire_cols), self.h2d_dtype)
            lengths = np.zeros((bsz,), np.int32)
            quantize = self.h2d_name in ("int8",) + _PACKED_WIRES
            for i, (c, l) in enumerate(zip(buf_chunks, buf_lens)):
                # Process-mode rows arrive converted; thread-mode f32 rows
                # into a quantized buffer need the rint quantizer (plain
                # assignment would truncate toward zero, or mismatch the
                # packed wire's shape).
                chunks[i] = (convert_h2d(c, self.h2d_name, self.scfg.clip_sigma)
                             if quantize and c.dtype != self.h2d_dtype else c)
                lengths[i] = l
            pb = PackedBatch(chunks=chunks, lengths=lengths,
                             sources=list(buf_src), n_real=n_real)
            buf_chunks.clear()
            buf_lens.clear()
            buf_src.clear()
            return pb

        for ridx, rc in enumerate(self.read_stream()):
            for ci in range(rc.chunks.n_chunks):
                buf_chunks.append(rc.chunks.chunks[ci])
                buf_lens.append(int(rc.chunks.lengths[ci]))
                buf_src.append((ridx, ci))
                if len(buf_chunks) == bsz:
                    yield flush()
        if buf_chunks:
            yield flush()


def stream_chunk_batches(
    root: str,
    scfg: SignalConfig,
    batch_chunks: int,
    num_workers: int = 4,
    files: list[str] | None = None,
) -> AsyncChunkPipeline:
    files = files if files is not None else list_signal_files(root)
    return AsyncChunkPipeline(files, scfg, batch_chunks, num_workers=num_workers).start()
