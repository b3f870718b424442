"""The dispatching thread's CPU time over its wall time while it issues
decode steps (the steps of `decode.host_ms_per_step`, each less its
blocking read), in percent: under 100 where the thread waited for the
interpreter lock or a core while launching."""

from portbench import spans


def read(ctx):
    steps = spans.outside_decode_steps(ctx)
    wall = sum(s.end_ns - s.start_ns - sum(c.end_ns - c.start_ns for c in syncs)
               for s, syncs in steps)
    if not wall:
        return None
    cpu = sum(s.cpu_ns - sum(c.cpu_ns for c in syncs) for s, syncs in steps)
    return 100.0 * cpu / wall
