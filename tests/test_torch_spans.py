"""The port's span recorder (`utils/profiling.py`) and the benchmark's
readers of its spans (`portbench/spans.py`, `portbench/metrics/`,
`portbench/spanrun.ClockedTracer`), on the CPU.

The engine's and the trainer's spans are tested beside their other tests
(tests/test_torch_engine.py, tests/test_torch_train.py).
"""

import ast
import os
import threading
import time
import types

import pytest
import torch

from nanodecoder_tpu_torch.utils import profiling
from nanodecoder_tpu_torch.utils.profiling import Span, StageTimer, span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _recorder_off():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_span_off_records_nothing_and_costs_under_a_microsecond():
    assert span("x", b=1) is span("y") is profiling._NULL
    with span("x", b=1, step=2, reads=3):
        pass
    assert profiling.drain() == []

    def per_call(n=200_000):     # the thread's CPU time: other processes' load aside
        t0 = time.thread_time()
        for _ in range(n):
            with span("decode.step", step=7):
                pass
        return (time.thread_time() - t0) / n

    assert min(per_call() for _ in range(3)) < 1e-6


def test_span_nesting_ids_threads_and_cpu_time():
    profiling.enable()
    with span("a", b=3):
        with span("b", step=7):
            with span("c", reads=2):
                t = time.thread_time()
                while time.thread_time() - t < 0.01:
                    pass
        time.sleep(0.03)
    other = threading.Thread(target=lambda: span("t").__enter__().__exit__(None, None, None))
    other.start()
    other.join(timeout=10)
    assert not other.is_alive()
    profiling.disable()
    with span("after"):
        pass
    got = {s.name: s for s in profiling.drain()}
    assert set(got) == {"a", "b", "c", "t"}
    a, b, c, t = got["a"], got["b"], got["c"], got["t"]
    assert (a.parent, b.parent, c.parent, t.parent) == (None, a.id, b.id, None)
    assert (a.b, a.step, b.b, b.step, c.b, c.step, c.reads) == (3, None, 3, 7, 3, 7, 2)
    assert a.start_ns <= b.start_ns <= c.start_ns < c.end_ns <= b.end_ns <= a.end_ns
    assert a.thread == b.thread == c.thread == threading.get_native_id() != t.thread
    assert a.pid == t.pid == os.getpid()
    assert c.cpu_ns >= 10_000_000                            # a 10-ms busy loop
    assert a.cpu_ns <= a.end_ns - a.start_ns - 25_000_000    # 30 ms asleep
    summary = profiling.SpanTotals().add([c, b, a]).summary()
    assert summary["a"]["count"] == 1
    assert summary["a"]["self_sec"] == pytest.approx(
        (a.end_ns - a.start_ns - (b.end_ns - b.start_ns)) * 1e-9)
    assert summary["c"]["self_sec"] == summary["c"]["total_sec"] == summary["c"]["mean_sec"]


def test_span_totals_carry_children_across_drains():
    """Totals folded drain by drain equal the totals of all the spans at
    once, a parent's children arriving in an earlier drain than it; only
    open parents' children are held."""
    def sp(name, t0, t1, id, parent=None):
        return Span(name, t0, t1, 0, 1, 1, id, parent, None, None, None)

    spans = [sp("step", 10, 30, 2, 1), sp("sync", 40, 45, 4, 3), sp("step", 35, 50, 3, 1),
             sp("dispatch", 0, 100, 1), sp("ingest.file", 5, 60, 5)]
    whole = profiling.SpanTotals().add(spans)
    parts = profiling.SpanTotals()
    for cut in ([0, 2], [2, 3], [3, 5]):
        parts.add(spans[cut[0]:cut[1]])
    assert parts.summary() == whole.summary()
    assert not parts.child_ns
    d = whole.summary()
    assert list(d) == ["step", "sync", "dispatch", "ingest.file"]
    assert d["dispatch"]["self_sec"] == pytest.approx(65e-9)
    assert d["step"] == pytest.approx({"count": 2, "total_sec": 35e-9, "self_sec": 30e-9,
                                       "mean_sec": 17.5e-9})


def test_summarized_folds_spans_while_the_block_runs():
    with profiling.summarized(every_s=0.01) as totals:
        for b in range(3):
            with span("dispatch", b=b):
                with span("decode.step"):
                    pass
        deadline = time.monotonic() + 10
        while profiling._REC.records and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not profiling._REC.records            # folded while the block runs
    assert not profiling._REC.on
    assert not [t for t in threading.enumerate() if t.name == "span-totals"]
    d = totals.summary()
    assert (d["dispatch"]["count"], d["decode.step"]["count"]) == (3, 3)
    assert d["dispatch"]["self_sec"] < d["dispatch"]["total_sec"]


def test_a_forked_child_records_its_own_process():
    """The thread's id and process id are looked up once a thread and
    forgotten in a forked child."""
    profiling.enable()
    with span("parent"):
        pass
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        with span("child"):
            pass
        (s,) = [x for x in profiling.drain() if x.name == "child"]
        os.write(w, b"1" if (s.pid, s.thread) == (os.getpid(), threading.get_native_id())
                 else b"0")
        os._exit(0)
    os.waitpid(pid, 0)
    assert os.read(r, 1) == b"1"
    os.close(r)
    os.close(w)
    (s,) = profiling.drain()
    assert (s.name, s.pid) == ("parent", os.getpid())


def test_timed_call_and_received():
    value = profiling.received(profiling.timed_call(sorted, [3, 1, 2]), "pool.call", reads=len)
    assert value == [1, 2, 3]
    assert profiling.received([9], "pool.call", reads=len) == [9]
    (s,) = profiling.drain()
    assert (s.name, s.reads, s.pid, s.parent) == ("pool.call", 3, os.getpid(), None)
    assert s.start_ns <= s.end_ns


def test_stage_timer_summary_same_with_the_recorder_on_and_off(monkeypatch):
    def summary(on: bool):
        ticks = iter(range(1000))
        monkeypatch.setattr(profiling.time, "perf_counter", lambda: float(next(ticks)))
        if on:
            profiling.enable()
        timer = StageTimer()
        for b in range(3):
            with timer.stage("dispatch", b=b):
                with timer.stage("inner"):
                    pass
        with timer.stage("wall"):
            pass
        profiling.disable()
        monkeypatch.undo()
        return timer.summary()

    assert summary(False) == summary(True)
    stages = profiling.drain()
    assert [s.name for s in stages].count("dispatch") == 3
    assert [s.b for s in stages if s.name == "inner"] == [0, 1, 2]


HOT_PATH = ["decode/engine.py", "decode/greedy.py", "decode/sampling.py", "decode/beam.py",
            "decode/translator.py", "io/pipeline.py", "train/trainer.py", "train/data.py"]


@pytest.mark.parametrize("path", HOT_PATH)
def test_no_profiler_annotation_on_the_hot_path(path):
    """The spans never reach a device trace: no record_function, NVTX or
    profiler import where the engine and the trainer run."""
    tree = ast.parse(open(os.path.join(REPO, "nanodecoder_tpu_torch", path)).read())
    banned = {"record_function", "nvtx", "profiler", "emit_nvtx"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr not in banned, node.attr
        elif isinstance(node, ast.Name):
            assert node.id not in banned, node.id
        elif isinstance(node, ast.Import):
            assert not any(w in a.name for a in node.names for w in banned)
        elif isinstance(node, ast.ImportFrom):
            assert not any(w in (node.module or "") for w in banned), node.module
            assert not banned & {a.name for a in node.names}


def test_clock_bridge_maps_spans_onto_the_profiler_events():
    """Program spans around known CPU ops, mapped with the offset that
    ClockedTracer measures, lie within 0.2 ms of those ops' profiler
    times."""
    from portbench.spanrun import ClockedTracer

    x = torch.randn(160, 160)
    torch.mm(x, x)
    tracer = ClockedTracer()
    profiling.enable()
    tracer.start()
    for _ in range(3):
        time.sleep(0.02)
        with span("mm"):
            torch.mm(x, x)
    prof = tracer._prof
    tracer.stop()
    profiling.disable()
    tr = tracer.trace
    assert tr.t1_ns - tr.t0_ns == pytest.approx(tr.window_s * 1e9, abs=1)
    assert 0 < tr.bracket_ns < 200_000 and tr.busy_ns == []
    mms = [s for s in profiling.drain() if s.name == "mm"]
    events = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(mms) == len(events) == 3
    for s, e in zip(mms, events):
        start = e.time_range.start * 1000 - tr.offset_ns
        end = e.time_range.end * 1000 - tr.offset_ns
        assert abs(start - s.start_ns) < 2e5 and abs(end - s.end_ns) < 2e5
        assert tr.t0_ns < start < end < tr.t1_ns


# ---------------------------------------------------------------------------
# The benchmark's readers on a synthetic run (times in ns; hand-computed).


def _span(name, start, end, cpu=0, thread=1, pid=1, id=0, parent=None, b=None, step=None,
          reads=None):
    return Span(name, start, end, cpu, thread, pid, id, parent, b, step, reads)


def _serve_ctx():
    """A warm-up run (wall 0-100) and a window run (wall 200-10200), the
    profiler over 2000-6000, the device busy 2000-2600, 3000-3400 and
    5000-6500.  Five decode steps, each ending in its blocking read; a
    step's host time is its wall less the read's."""
    s = [_span("wall", 0, 100, id=1), _span("wall", 200, 10200, id=2),
         _span("decode.step", 10, 60, id=3), _span("decode.sync", 50, 60, id=4, parent=3)]
    for d, (a, z) in enumerate([(1000, 1900), (2200, 4200), (4600, 5800), (6200, 7000)]):
        s.append(_span("dispatch", a, z, id=10 + d, b=d))
    steps = [(1100, 1500, 1400, 350, 50), (2300, 3300, 3100, 0, 0), (3300, 4100, 3900, 0, 0),
             (4700, 5700, 5500, 0, 0), (6300, 6900, 6700, 300, 100)]
    for i, (a, z, sync, cpu, sync_cpu) in enumerate(steps):
        s.append(_span("decode.step", a, z, cpu=cpu, id=20 + i))
        s.append(_span("decode.sync", sync, z, cpu=sync_cpu, id=30 + i, parent=20 + i))
    s += [_span("engine.copy_wait", 20, 90, cpu=70, thread=2),
          _span("engine.copy_wait", 1800, 2500, cpu=100, thread=2),
          _span("engine.copy_wait", 7000, 9000, cpu=1900, thread=2),
          _span("ingest.file", 5, 80, cpu=10**6, pid=77, reads=3),
          _span("ingest.file", 150, 900, cpu=6 * 10**6, pid=77, reads=8),
          _span("ingest.file", 500, 10100, cpu=3 * 10**6, pid=78, reads=4),
          _span("ingest.file", 9000, 10300, cpu=9 * 10**6, pid=78, reads=5)]
    trace = types.SimpleNamespace(t0_ns=2000, t1_ns=6000, n_device_ops=5, window_s=4e-6,
                                  busy_ns=[(3000, 3400), (2000, 2600), (5000, 6500)])
    return {"kind": "serve", "spans": s, "trace": trace}


def _train_ctx():
    """Three set-up steps (0-2) and six window steps (3-8), the profiler
    over 1000-5000: steps 3, 7 and 8 lie outside it."""
    s = [_span("train.data_wait", 100 * i, 100 * i + 100, step=i) for i in range(3)]
    s += [_span("train.data_wait", 1000 * i, 1000 * i + (400 if i == 8 else 200), step=i)
          for i in range(3, 9)]
    s += [_span("train.h2d", 100, 300, step=1), _span("train.forward", 300, 900, step=1),
          _span("train.h2d", 400, 600, step=3), _span("train.forward", 600, 800, step=3),
          _span("train.backward", 800, 900, step=3), _span("train.update", 900, 950, step=3),
          _span("train.h2d", 3000, 4000, step=5), _span("train.forward", 4800, 5100, step=6),
          _span("train.h2d", 5100, 5400, step=7),
          _span("train.forward", 5400, 6400, step=7), _span("train.backward", 6400, 8400, step=7),
          _span("train.update", 8400, 8900, step=7),
          _span("train.h2d", 6100, 6600, step=8),
          _span("train.forward", 9000, 10500, step=8),
          _span("train.backward", 10500, 13000, step=8),
          _span("train.update", 13000, 13500, step=8)]
    trace = types.SimpleNamespace(t0_ns=1000, t1_ns=5000, n_device_ops=5, window_s=4e-6,
                                  busy_ns=[])
    return {"kind": "train", "spans": s, "trace": trace, "window_s": 20e-6}


@pytest.mark.parametrize("name,ctx,want", [
    # steps 1 and 5 lie outside the profiled window: (400-100 + 600-200) / 2
    ("decode.host_ms_per_step", _serve_ctx, 350e-6),
    # CPU (350-50) + (300-100) over the same 700 ns
    ("decode.step_cpu_share", _serve_ctx, 100.0 * 500 / 700),
    # launching in the window: 2300-3100, 3300-3900, 4700-5500 (2200 ns), busy 1000 of it
    ("device_idle.serve_launch", _serve_ctx, 100.0 * 1200 / 4000),
    # outside dispatch: 2000-2200, 4200-4600, 5800-6000 (800 ns), busy 400 of it
    ("device_idle.serve_between", _serve_ctx, 100.0 * 400 / 4000),
    # the window run's two waits (100 + 1900 ns of CPU) over its 10000 ns wall
    ("engine.copy_wait_cores", _serve_ctx, 0.2),
    # the calls that ended in the window run: 9 ms of CPU over 12 reads
    ("ingest.cpu_ms_per_read", _serve_ctx, 0.75),
    # the window steps' waits, 5 x 200 + 400 ns, over the 20000-ns window
    ("train.feed_wait_share", _train_ctx, 7.0),
    # steps 3, 7 and 8: (200 + 300 + 500) / 3 ns
    ("train.h2d_ms_per_step", _train_ctx, 1000e-6 / 3),
    # steps 3, 7 and 8: (350 + 3500 + 4500) / 3 ns
    ("train.host_ms_per_step", _train_ctx, 8350e-6 / 3),
])
def test_span_metric_readers(name, ctx, want):
    from portbench import run

    read = run.metric_reader(name)
    full = ctx()
    assert read(full) == pytest.approx(want, rel=1e-9)
    assert read({"kind": full["kind"]}) is None
    assert read(dict(full, spans=[])) is None     # the recorder was off


def test_idle_split_within_the_device_idle_share():
    """Launch and between cover disjoint host intervals, so together they
    stay within the window's idle share."""
    from portbench import run

    ctx = _serve_ctx()
    idle = 100.0 * (1 - (600 + 400 + 1000) / 4000)
    launch = run.metric_reader("device_idle.serve_launch")(ctx)
    between = run.metric_reader("device_idle.serve_between")(ctx)
    assert launch + between <= idle
