"""Host milliseconds a decode step spends issuing its work: the mean over
the window's steps outside the profiled batches of the program's
`decode.step` span less its `decode.sync` child (the step's blocking
read of the finished flags)."""

from portbench import spans


def read(ctx):
    steps = spans.outside_decode_steps(ctx)
    if not steps:
        return None
    ns = sum(s.end_ns - s.start_ns - sum(c.end_ns - c.start_ns for c in syncs)
             for s, syncs in steps)
    return ns / len(steps) / 1e6
