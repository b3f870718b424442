"""The program's spans as the per-layer readers see them.

A traced run (`portbench.run --trace 1`) runs the program's span recorder
(`nanodecoder_tpu_torch.utils.profiling`) from before set-up to the end
of the window and hands its readers `ctx["spans"]`, every span it
recorded (set-up and window), and `ctx["trace"]` (`trace.Trace`) with
the profiled window on the spans' clock (`time.perf_counter_ns`), `t0_ns`
and `t1_ns`, and `busy_ns`, the merged intervals in which an operation
ran on the device, on that clock.

Intervals are sorted lists of disjoint (start, end) pairs in ns.
"""

from __future__ import annotations

from portbench.train import READ_STEPS


def merge(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def intersect(x, y) -> list[tuple[int, int]]:
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(x, y) -> list[tuple[int, int]]:
    """x less y."""
    out, j = [], 0
    for a, b in x:
        while j < len(y) and y[j][1] <= a:
            j += 1
        k = j
        while k < len(y) and y[k][0] < b:
            c, d = y[k]
            if c > a:
                out.append((a, c))
            a = max(a, d)
            k += 1
        if a < b:
            out.append((a, b))
    return out


def of(ctx, *names) -> list:
    return [s for s in ctx.get("spans") or [] if s.name in names]


def window_run(ctx, *names) -> tuple[list, int]:
    """The spans named that ended in the engine's last run (after the end
    of the run before it: the set-up's warm-up), and that run's wall in
    ns; ([], 0) without a run."""
    walls = sorted(of(ctx, "wall"), key=lambda s: s.end_ns)
    if not walls:
        return [], 0
    lo, hi = (walls[-2].end_ns if len(walls) > 1 else -1), walls[-1].end_ns
    return ([s for s in of(ctx, *names) if lo < s.end_ns <= hi],
            walls[-1].end_ns - walls[-1].start_ns)


def profiled(ctx) -> tuple[int, int, list] | None:
    """(t0, t1, the device's busy intervals in between) of the profiled
    window on the spans' clock, or None where the trace lacks them."""
    trace = ctx.get("trace")
    if trace is None or not trace.n_device_ops:
        return None
    t0, t1 = trace.t0_ns, trace.t1_ns
    return t0, t1, intersect(merge(trace.busy_ns), [(t0, t1)])


def outside_decode_steps(ctx) -> list[tuple]:
    """(decode.step span, its decode.sync children) of the window run's
    decode steps outside the profiled window (the batches the profiler does
    not slow)."""
    trace = ctx.get("trace")
    steps, _wall = window_run(ctx, "decode.step")
    if trace is None or not steps:
        return []
    t0, t1 = trace.t0_ns, trace.t1_ns
    syncs: dict[int, list] = {}
    for s in of(ctx, "decode.sync"):
        syncs.setdefault(s.parent, []).append(s)
    return [(s, syncs.get(s.id, [])) for s in steps if s.end_ns <= t0 or s.start_ns >= t1]


def idle_share(ctx, where) -> float | None:
    """Percent of the profiled window in which no device op ran while the
    dispatching thread was in `where(ctx, t0, t1)` (intervals, or None
    without the spans that tell)."""
    win = profiled(ctx)
    if win is None:
        return None
    t0, t1, busy = win
    inside = where(ctx, t0, t1)
    if inside is None:
        return None
    inside = intersect(inside, [(t0, t1)])
    return 100.0 * (length(inside) - length(intersect(inside, busy))) / (t1 - t0)


def outside_train_steps(ctx, *names) -> list:
    """The spans named of the training window's steps (after the set-up's
    READ_STEPS) that lie outside the profiled window."""
    trace = ctx.get("trace")
    if trace is None:
        return []
    return [s for s in of(ctx, *names) if s.step is not None and s.step >= READ_STEPS
            and (s.end_ns <= trace.t0_ns or s.start_ns >= trace.t1_ns)]
