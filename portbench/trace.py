"""The device trace of a traced run, read from torch.profiler.

`Tracer` starts the profiler (host and CUDA activity) and stops it; its
`Trace` holds what the per-layer readers and the result line need: the
traced window's length, the seconds in which an operation ran on the
device (the union of the device operations' intervals), the device time
and count of each operation by name, and the idle gaps between device
operations, each named by the host operation that was running on the
dispatching thread at the gap's middle.
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
        self.trace: Trace | None = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self._prof.stop()
        self.trace = summarize(self._prof.events(), window)
        self._prof = None


def summarize(events, window_s: float) -> Trace:
    dev, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            dev.append(e)
        elif e.cpu_parent is None:
            host.append(e)
    ops: dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    spans = []
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        ops[e.name][0] += 1
        ops[e.name][1] += (b - a) * 1e-6
        spans.append((a, b))
    spans.sort()
    merged: list[list[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
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
