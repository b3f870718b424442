"""The device trace of a traced run, read from torch.profiler.

`Tracer` starts the profiler (host and CUDA activity) and stops it; its
`Trace` holds what the per-layer readers and the result line need: the
traced window's length, the seconds in which an operation ran on the
device (the union of the device operations' intervals), the device time
and count of each operation by name, and the idle gaps between device
operations, each named by the host operation that was running on the
dispatching thread at the gap's middle.

It also puts the trace on the clock of the program's spans
(`time.perf_counter_ns`): `t0_ns` and `t1_ns`, the profiled window;
`offset_ns`, the profiler's event clock (in ns) less `perf_counter_ns`;
`busy_ns`, the merged device intervals on `perf_counter_ns`.  The offset
is measured, not assumed: at the start one CPU-only op (`aten::gcd`,
which the program never runs) is bracketed by two `perf_counter_ns`
reads and found among the profiler's events; the narrowest of three
brackets, `bracket_ns`, is the offset's error.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

import torch
from torch.autograd import DeviceType


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: dict[str, tuple[int, float]]       # name -> (count, device seconds)
    gaps: dict[str, float]                  # host activity -> idle seconds
    n_device_ops: int
    t0_ns: int = 0
    t1_ns: int = 0
    offset_ns: int = 0
    bracket_ns: int = 0
    busy_ns: list[tuple[int, int]] = dataclasses.field(default_factory=list)

    def time_of(self, *fragments: str) -> tuple[int, float]:
        """(count, seconds) of the device operations whose name holds one
        of `fragments`."""
        n, s = 0, 0.0
        for name, (c, t) in self.ops.items():
            if any(f in name for f in fragments):
                n, s = n + c, s + t
        return n, s

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:200], t] for n, (_c, t) in top],
                "idle_gaps": [[n[:200], t] for n, t in gaps]}


class Tracer:
    def __init__(self):
        self._prof = None
        self._t0 = 0.0
        self._brackets: list[tuple[int, int]] = []
        self.trace: Trace | None = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        x, y = torch.tensor([6]), torch.tensor([4])
        torch.gcd(x, y)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()
        self._brackets = []
        for _ in range(3):
            a = time.perf_counter_ns()
            torch.gcd(x, y)
            self._brackets.append((a, time.perf_counter_ns()))

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self._prof.stop()
        events = self._prof.events()
        tr = self.trace = summarize(events, window)
        marks = [e for e in events if e.name == "aten::gcd"]
        (a, b), mark = min(zip(self._brackets, marks), key=lambda bm: bm[0][1] - bm[0][0])
        tr.offset_ns = round((mark.time_range.start + mark.time_range.end) * 500 - (a + b) / 2)
        tr.bracket_ns = b - a
        tr.t0_ns = round(self._t0 * 1e9)
        tr.t1_ns = tr.t0_ns + round(window * 1e9)
        tr.busy_ns = [(round(a * 1000) - tr.offset_ns, round(b * 1000) - tr.offset_ns)
                      for a, b in device_intervals(events)]
        self._prof = None


def summarize(events, window_s: float) -> Trace:
    dev, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            dev.append(e)
        elif e.cpu_parent is None:
            host.append(e)
    ops: dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        ops[e.name][0] += 1
        ops[e.name][1] += (e.time_range.end - e.time_range.start) * 1e-6
    merged = device_intervals(dev)
    busy = sum(b - a for a, b in merged) * 1e-6
    # The dispatching thread: the one with the most top-level host ops.
    threads = collections.Counter(e.thread for e in host)
    main = threads.most_common(1)[0][0] if threads else None
    hs = sorted((e.time_range.start, e.time_range.end, e.name) for e in host
                if e.thread == main)
    starts = [h[0] for h in hs]
    gaps: dict[str, float] = collections.defaultdict(float)
    for (_a, b), (c, _d) in zip(merged, merged[1:]):
        mid = (b + c) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = hs[i][2] if i >= 0 and hs[i][1] >= mid else "host outside any torch op"
        gaps[name] += (c - b) * 1e-6
    return Trace(window_s=window_s, busy_s=busy,
                 ops={k: (v[0], v[1]) for k, v in ops.items()}, gaps=dict(gaps),
                 n_device_ops=len(dev))


def device_intervals(events) -> list[list[float]]:
    """The merged intervals, in the profiler's microseconds, in which a device
    operation of `events` ran."""
    out: list[list[float]] = []
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
