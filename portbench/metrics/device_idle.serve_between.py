"""Share of the profiled serving window in which no operation ran on the
device while the dispatching thread was outside the engine's `dispatch`
stage (waiting for ingest, packing a batch, or held back by the result
queue), in percent."""

from portbench import spans


def between(ctx, t0, t1):
    dispatch = spans.merge((s.start_ns, s.end_ns) for s in spans.of(ctx, "dispatch"))
    return spans.subtract([(t0, t1)], dispatch) if dispatch else None


def read(ctx):
    return spans.idle_share(ctx, between)
