"""Spans, per-stage wall-clock timers and the device trace (the port's
counterpart of `nanodecoder_tpu.utils.profiling`: `StageTimer`, and
`device_trace` on torch.profiler where the JAX package's runs
jax.profiler).

The span recorder is process-wide and off by default: `enable()`,
`disable()`, and `drain()`, which hands out the spans recorded so far;
`summarized()` records a block's spans into per-name totals as it runs.
`span(name, b=, step=, reads=)` is a context manager; each span keeps its
name, its start and end (`time.perf_counter_ns()`, CLOCK_MONOTONIC on
Linux: one clock for every process of the machine), its thread and
process, its parent (the span open on the same thread when it began),
the thread's CPU time over it, and its ids: the batch number `b`, the
step number and the number of reads.  A span given no batch or step
number takes its parent's.  While the recorder is off, `span()` returns
one shared do-nothing context.  Work run in a process pool is timed by
`timed_call` in the worker, submitted through `submit` and recorded by
`received` where its result comes back.  Nothing here touches the device
or the profiler: the spans never reach a device trace.
"""

from __future__ import annotations

import contextlib
import itertools
from collections import deque
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    cpu_ns: int              # the thread's CPU time over the span (a pool call's: its process's)
    thread: int              # threading.get_native_id() of the thread that ran it
    pid: int
    id: int
    parent: int | None       # the id of the span open on the thread when it began
    b: int | None            # batch number
    step: int | None
    reads: int | None


class _Recorder:
    def __init__(self):
        self.on = False
        self.records: deque[Span] = deque()     # appended and drained by any thread
        self.ids = itertools.count(1)
        self.forget()

    def forget(self) -> None:
        self.local = threading.local()

    def thread(self) -> tuple[list, int, int]:
        """The calling thread's stack of open spans, its native id and its
        process id, looked up once a thread (each a system call)."""
        try:
            return self.local.state
        except AttributeError:
            self.local.state = ([], threading.get_native_id(), os.getpid())
            return self.local.state


_REC = _Recorder()
os.register_at_fork(after_in_child=_REC.forget)
_NULL = contextlib.nullcontext()


def enable() -> None:
    _REC.on = True


def disable() -> None:
    _REC.on = False


def drain() -> list[Span]:
    """The spans recorded since the last drain, in the order they ended
    (a child before its parent)."""
    records = _REC.records
    return [records.popleft() for _ in range(len(records))]


class _Span:
    __slots__ = ("name", "b", "step", "reads", "id", "parent", "t0", "c0")

    def __init__(self, name, b, step, reads):
        self.name, self.b, self.step, self.reads = name, b, step, reads

    def __enter__(self):
        stack = _REC.thread()[0]
        if stack:
            self.parent, pb, pstep = stack[-1]
            if self.b is None:
                self.b = pb
            if self.step is None:
                self.step = pstep
        else:
            self.parent = None
        self.id = next(_REC.ids)
        stack.append((self.id, self.b, self.step))
        self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        c1 = time.thread_time_ns()
        stack, thread, pid = _REC.thread()
        stack.pop()
        _REC.records.append(Span(self.name, self.t0, t1, c1 - self.c0, thread, pid, self.id,
                                 self.parent, self.b, self.step, self.reads))
        return False


def span(name: str, b: int | None = None, step: int | None = None, reads: int | None = None):
    """A context that records a span while the recorder is on."""
    if not _REC.on:
        return _NULL
    return _Span(name, b, step, reads)


class Timed(NamedTuple):
    """A pool call's result with its wall start and end and its process's
    CPU time, taken in the worker by `timed_call`."""
    value: object
    start_ns: int
    end_ns: int
    cpu_ns: int
    thread: int
    pid: int


def timed_call(fn, *args) -> Timed:
    """fn(*args), timed where it runs (a pool process)."""
    c0, t0 = time.process_time_ns(), time.perf_counter_ns()
    value = fn(*args)
    t1, c1 = time.perf_counter_ns(), time.process_time_ns()
    return Timed(value, t0, t1, c1 - c0, threading.get_native_id(), os.getpid())


def submit(pool, fn, *args):
    """pool.submit(fn, *args); while the recorder is on, through
    `timed_call`, which `received` unwraps."""
    if _REC.on:
        return pool.submit(timed_call, fn, *args)
    return pool.submit(fn, *args)


def received(result, name: str, reads=None):
    """The value of a call that `submit` sent, recording it as span `name`
    where it was timed; `reads`, a function of the value, gives the span's
    number of reads."""
    if type(result) is not Timed:
        return result
    _REC.records.append(Span(name, result.start_ns, result.end_ns, result.cpu_ns,
                             result.thread, result.pid, next(_REC.ids), None, None, None,
                             reads(result.value) if reads is not None else None))
    return result.value


class SpanTotals:
    """Per span name: count, total, mean and self seconds (self: the spans'
    time less their children's), folded from drained spans as they come,
    in the order the names first ended.  A child ends before its parent;
    its time is held by the parent's id until the parent comes."""

    def __init__(self):
        self.totals: dict[str, dict[str, float]] = {}
        self.child_ns: dict[int, int] = defaultdict(int)

    def add(self, spans) -> SpanTotals:
        for s in spans:
            dur = s.end_ns - s.start_ns
            if s.parent is not None:
                self.child_ns[s.parent] += dur
            d = self.totals.setdefault(s.name, {"count": 0, "total_sec": 0.0, "self_sec": 0.0})
            d["count"] += 1
            d["total_sec"] += dur * 1e-9
            d["self_sec"] += (dur - self.child_ns.pop(s.id, 0)) * 1e-9
        return self

    def summary(self) -> dict[str, dict[str, float]]:
        return {name: {**d, "mean_sec": d["total_sec"] / d["count"]}
                for name, d in self.totals.items()}


@contextlib.contextmanager
def summarized(every_s: float = 5.0):
    """Turn the recorder on for the block and fold its spans into the
    `SpanTotals` it yields every `every_s` seconds, so that a long run
    holds one entry a name rather than every span; complete when the
    block ends."""
    totals, done = SpanTotals(), threading.Event()

    def fold():
        while not done.wait(every_s):
            totals.add(drain())

    folder = threading.Thread(target=fold, name="span-totals", daemon=True)
    enable()
    folder.start()
    try:
        yield totals
    finally:
        disable()
        done.set()
        folder.join()
        totals.add(drain())


class StageTimer:
    """Accumulating named wall-clock timers; each stage is also a span
    while the recorder is on.

    with timer.stage("decode"): ...
    timer.summary() -> {"decode": {"total_sec": ..., "count": ...}, ...}
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, b: int | None = None):
        t0 = time.perf_counter()
        try:
            with span(name, b=b):
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
