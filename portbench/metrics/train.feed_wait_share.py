"""Share of the training window the step loop waited on the program's
`prefetch_batches` for its next batch, from the program's
`train.data_wait` spans of the window's steps, in percent (the program's
twin of `train.data_wait_share`, which the benchmark times around the
same call)."""

from portbench import spans
from portbench.train import READ_STEPS


def read(ctx):
    waits = [s for s in spans.of(ctx, "train.data_wait") if s.step >= READ_STEPS]
    if not waits or not ctx.get("window_s"):
        return None
    return 100.0 * sum(s.end_ns - s.start_ns for s in waits) / 1e9 / ctx["window_s"]
