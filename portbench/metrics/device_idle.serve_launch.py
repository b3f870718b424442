"""Share of the profiled serving window in which no operation ran on the
device while the dispatching thread was inside a decode step and outside
its blocking read (`decode.step` less `decode.sync`), in percent: the
idle time the host's launches leave."""

from portbench import spans


def launching(ctx, _t0, _t1):
    steps = spans.merge((s.start_ns, s.end_ns) for s in spans.of(ctx, "decode.step"))
    if not steps:
        return None
    syncs = spans.merge((s.start_ns, s.end_ns) for s in spans.of(ctx, "decode.sync"))
    return spans.subtract(steps, syncs)


def read(ctx):
    return spans.idle_share(ctx, launching)
