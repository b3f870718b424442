"""Cores the engine's copy pool keeps busy waiting for batches' copies to
the host: the thread CPU seconds of the window run's `engine.copy_wait`
spans (`event.synchronize()`) over the run's wall.  Near 0 where the
wait sleeps; near the waits' wall over the run's where it spins."""

from portbench import spans


def read(ctx):
    waits, wall_ns = spans.window_run(ctx, "engine.copy_wait")
    if not waits or not wall_ns:
        return None
    return sum(s.cpu_ns for s in waits) / wall_ns
