"""Host milliseconds of a training step's forward, backward and update:
the program's `train.forward`, `train.backward` and `train.update` spans
of the window's steps outside the profiled ones, over those steps."""

from portbench import spans


def read(ctx):
    parts = spans.outside_train_steps(ctx, "train.forward", "train.backward", "train.update")
    steps = {s.step for s in parts}
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in parts) / len(steps) / 1e6
