"""Host cost from read to wire: the ingest processes' CPU milliseconds in
the window run's `ingest.file` calls (read, normalization, chunks, the
wire conversion) over the reads those calls produced."""

from portbench import spans


def read(ctx):
    calls, _wall = spans.window_run(ctx, "ingest.file")
    n = sum(s.reads or 0 for s in calls)
    if not n:
        return None
    return sum(s.cpu_ns for s in calls) / 1e6 / n
