"""Streaming basecall engine: ingest -> device batches -> FASTQ (the
port's counterpart of `nanodecoder_tpu.decode.engine`).

  * chunks from MANY reads are packed into one fixed batch shape
    (io/pipeline), so every batch is full but the last;
  * each batch is encoded and decoded by `Translator.decode_program`,
    the code the Translator runs, and comes back in the compact form
    (int16 ids and positions, f16 log-probs);
  * dispatch-ahead: a bounded queue of `depth` batches between the
    dispatching thread and a collector thread, and a thread pool for the
    device->host copies, so ingest and stitching overlap the device.
    The port's decode loop waits on the card every step, so the device
    runs one batch at a time; a captured decode loop would let batches
    overlap there too;
  * reads are stitched and written the moment their last chunk arrives
    (bounded memory over any number of reads), in the process pool;
  * resumable: completed read ids can be skipped on restart.

Greedy, beam and sample mode, as `Translator` serves them; in sample
mode the batches are numbered for their keys (fold_in(PRNGKey(
sampling_seed), batch_no), as the JAX engine numbers them) in dispatch
order (one dispatching thread), whatever the depth.

Data-parallel decode (`mesh_plan`, a `parallel.mesh.MeshPlan`): every rank
runs the engine on the same files and so packs the same batches; each
decodes its rows of every batch, the rows are gathered (one collective a
batch), and rank 0 finishes and writes every read while the other ranks
write nothing.  The FASTQ equals one device's.  Each rank's stop flag
rides in that collective, so when rank 0's writing fails every rank
leaves after the same batch (and raises) instead of waiting in the next
gather.  The JAX engine's warning
about beam state spilling a TPU core's VMEM is not carried over: this
card has no such wall.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable

import numpy as np
import torch

from nanodecoder_tpu_torch.config import Config
from nanodecoder_tpu_torch.decode.finish import _finish_read_task
from nanodecoder_tpu_torch.decode.translator import Translator
from nanodecoder_tpu_torch.io.pipeline import AsyncChunkPipeline, _get_ingest_pool
from nanodecoder_tpu_torch.utils import profiling
from nanodecoder_tpu_torch.utils.profiling import StageTimer, span
from nanodecoder_tpu_torch.utils.statistics import ThroughputMeter


class StreamingBasecaller:
    def __init__(self, params, config: Config, depth: int = 2, attn_pos: bool = True,
                 device: str | torch.device = "cuda", mesh_plan=None):
        """params: the nested parameter dict of
        train.checkpoint.load_params_npz; the serving fold runs once here,
        on `device` (the card unless the caller asks for the CPU; with a
        `mesh_plan`, this rank's device).  config.decode.mode: greedy, beam
        or sample.

        attn_pos=False drops the per-token attention positions from the
        device->host copy: only the "attn" stitcher reads them."""
        self.config = config
        self.depth = depth
        self.attn_pos = attn_pos
        self._translator = Translator(params, config, device=device)
        self.device = self._translator.device
        self._h2d = self._translator._h2d
        self._program = self._translator.decode_program
        self._sharded = mesh_plan is not None
        self._writer = True
        if self._sharded:
            self._program = mesh_plan.shard_decode_fn(self._program)
            self._writer = mesh_plan.rank == 0

    @property
    def batches(self) -> int:
        """Device batches run so far."""
        return self._translator.batches

    @property
    def decode_steps(self) -> int:
        """Decode steps run so far, over all batches."""
        return self._translator.decode_steps

    def _decode(self, wire: np.ndarray, lengths: np.ndarray, stop: bool = False):
        """Dispatch one batch.  Returns (host tensors, event, stop): the
        compact outputs, their copy to host memory queued right behind the
        batch's kernels (pinned, asynchronous), and an event recorded after
        it; on the CPU the tensors themselves and no event; (None, None) on
        a rank that writes nothing.  `stop`: with a mesh plan, whether any
        rank passed stop=True for this batch (else False)."""
        with torch.inference_mode():
            if self._sharded:
                (tokens, tlens, lps, _scores, pos), stop = self._program(wire, lengths,
                                                                         stop=stop)
            else:
                (tokens, tlens, lps, _scores, pos), stop = self._program(wire, lengths), False
        self._translator.batches += 1
        if not self._writer:
            return None, None, stop
        outs = (tokens, tlens, lps) + ((pos,) if self.attn_pos else ())
        if self.device.type != "cuda":
            return outs, None, stop
        with span("engine.d2h_enqueue"):
            host = tuple(x.to("cpu", non_blocking=True) for x in outs)
            event = torch.cuda.Event()
            event.record()
        return host, event, stop

    # -----------------------------------------------------------------

    def run(
        self,
        files: list[str],
        out,
        stitch_method: str = "trim",
        skip_read_ids: Iterable[str] = (),
        num_workers: int = 4,
        meter: ThroughputMeter | None = None,
        write_format: str = "fastq",
        done_log=None,
        stage_timer: StageTimer | None = None,
    ) -> ThroughputMeter:
        """Basecall `files`, writing FASTQ/FASTA records to text file `out`
        in read-completion order (with a mesh plan, on rank 0 only: the
        other ranks decode their rows and return an empty meter).

        `done_log`: optional file handle; completed read ids are appended
        one per line (resume: pass the previous contents as
        `skip_read_ids` on restart).
        `stage_timer`: optional StageTimer that accumulates the wall time
        of each stage: on the dispatching thread ingest-wait, dispatch
        and backpressure-wait (blocked on the bounded result queue); on
        the collector thread d2h-wait and stitch+write.  The two chains
        run concurrently; each chain's stages sum to its busy time, and
        "wall" holds the run's wall time.  While the span recorder is on
        (utils/profiling.py), each stage is also a span, with the batch
        number `b` (counted from 0 each run), beside the spans inside
        them (the ingest's, the encode's, each decode step's) and those
        of the copy waits and of the pool's ingest and finishing calls."""
        timer = stage_timer if stage_timer is not None else StageTimer()
        cfg = self.config
        skip = set(skip_read_ids)
        pipe = AsyncChunkPipeline(
            files, cfg.signal, cfg.decode.effective_batch_chunks(engine=True),
            num_workers=num_workers, h2d_dtype=self._h2d,
        ).start()
        meter = meter or ThroughputMeter(n_reads=0)

        # Per-read assembly state: read index -> chunk index -> outputs.
        per_read: dict[int, dict[int, tuple]] = collections.defaultdict(dict)
        # Per-read finishing runs in the shared ingest process pool; the
        # collector only submits a few KB of token arrays and later writes
        # the returned record.  Output order = read completion order (a
        # FIFO of futures submitted in chunk order).
        stitch_pool = _get_ingest_pool(num_workers)
        stitch_futs: collections.deque = collections.deque()

        def finish_read(ridx: int) -> None:
            rc = pipe.reads[ridx]
            if rc.read.read_id in skip:
                per_read.pop(ridx, None)
                return
            parts = per_read.pop(ridx)
            cb = rc.chunks
            stitch_futs.append((
                profiling.submit(stitch_pool, _finish_read_task, rc.read.read_id,
                                 [parts[ci] for ci in range(cb.n_chunks)],
                                 cb.starts, cb.lengths, cb.chunk_len,
                                 cb.chunk_overlap, stitch_method, cfg.model.kmer_k,
                                 write_format),
                rc.read.read_id, cb.total_samples, cb.n_chunks,
            ))

        def drain_finished(block: bool = False) -> None:
            """Write completed records (FIFO).  block=True waits for all."""
            while stitch_futs and (block or stitch_futs[0][0].done()):
                fut, read_id, n_samples, n_chunks = stitch_futs.popleft()
                record, n_bases = profiling.received(fut.result(), "finish.read")
                out.write(record)
                if done_log is not None:
                    done_log.write(read_id + "\n")
                meter.update(n_samples, n_bases, n_chunks, 1)

        # Collection (device->host wait, assembly, stitch, write) runs on
        # its own thread behind a bounded queue, whose bound is the
        # dispatch-ahead depth; the waits for the copies go through a small
        # thread pool, and the FIFO queue keeps their order.
        depth = max(self.depth, 1)
        result_q: queue.Queue = queue.Queue(maxsize=depth)
        transfer_pool = ThreadPoolExecutor(max_workers=depth,
                                           thread_name_prefix="engine-d2h")
        collector_exc: list[BaseException] = []

        def to_host(host, event, b: int):
            if event is not None:
                with span("engine.copy_wait", b=b):
                    event.synchronize()
            return tuple(x.numpy() for x in host)

        def collect_one(item) -> None:
            fut, packed, b = item
            with timer.stage("d2h-wait", b=b):
                tokens, tlens, lps, *rest = fut.result()
                # attn_pos=False: positions never crossed; the expansion
                # still needs a same-shape array (the trim and align
                # stitchers do not read its values).
                pos = rest[0] if rest else np.zeros_like(tokens)
            with timer.stage("stitch+write", b=b):
                for row, (ridx, ci) in enumerate(packed.sources):
                    per_read[ridx][ci] = (tokens[row], int(tlens[row]), lps[row], pos[row])
                    if len(per_read[ridx]) == pipe.reads[ridx].chunks.n_chunks:
                        finish_read(ridx)
                drain_finished()
                # One durability point per batch, not per read.  The
                # OUTPUT flushes first, so it is always at least as
                # durable as the done log: a crash between the two can
                # only re-basecall reads, never drop records that the
                # done log claims.
                if done_log is not None:
                    out.flush()
                    done_log.flush()

        def collector() -> None:
            while True:
                item = result_q.get()
                if item is None:
                    # Final drain: wait out the in-flight finishing tasks.
                    if not collector_exc:
                        try:
                            with timer.stage("stitch+write"):
                                drain_finished(block=True)
                                if done_log is not None:
                                    out.flush()
                                    done_log.flush()
                        except BaseException as e:  # noqa: BLE001 - relayed to caller
                            collector_exc.append(e)
                    return
                if not collector_exc:
                    try:
                        collect_one(item)
                    except BaseException as e:  # noqa: BLE001 - relayed to caller
                        collector_exc.append(e)
                # After a failure, keep draining so the producer's
                # bounded put() never deadlocks.

        col_thread = threading.Thread(target=collector, name="engine-collector",
                                      daemon=True)
        col_thread.start()
        stopped = False  # a rank's stop flag came back in a gather
        with timer.stage("wall"):
            try:
                batches = pipe.batches()
                # With a mesh plan, a failure leaves the loop through the
                # flag of the next gather, which every rank joins.
                b = -1
                while self._sharded or not collector_exc:
                    b += 1
                    with timer.stage("ingest-wait", b=b):
                        packed = next(batches, None)
                    if packed is None:
                        break
                    with timer.stage("dispatch", b=b):
                        host, event, stopped = self._decode(packed.chunks, packed.lengths,
                                                            bool(collector_exc))
                        fut = None if host is None or stopped else \
                            transfer_pool.submit(to_host, host, event, b)
                    if stopped:
                        break
                    if fut is None:
                        continue
                    with timer.stage("backpressure-wait", b=b):
                        result_q.put((fut, packed, b))
            finally:
                result_q.put(None)
                col_thread.join()
                transfer_pool.shutdown(wait=False)
                pipe.stop()
        if collector_exc:
            raise collector_exc[0]
        if stopped:
            raise RuntimeError("a rank of the mesh stopped the run (rank 0 failed to "
                               f"write) after batch {self.batches}")
        return meter
