"""A cell's spec cut to a size the CPU runs in seconds: the flagship at its
widths, 16-chunk batches of short reads, a few reads compared."""

from portbench import run


def tiny_spec(workload: str) -> dict:
    spec = run.cell_spec(workload)
    t = spec["traffic"]
    if t["kind"] == "serve":
        t.update(batch_chunks=16, workers=2, identity_reads=24, compare_from=48,
                 trace_batches=[1, 2])
        t["reads"] = dict(t["reads"], median_bases=600, min_bases=300, max_bases=1500)
    else:
        t.update(batch=4, trace_steps=[1, 2])
    return spec
