"""Host milliseconds a training step spends issuing its work: the
program's `train.forward`, `train.backward` and `train.update` spans of
an eager step, or the `train.replay` span of a step replayed through its
CUDA graph, over the window's steps outside the profiled ones."""

from portbench import spans


def read(ctx):
    parts = spans.outside_train_steps(ctx, "train.forward", "train.backward", "train.update",
                                      "train.replay")
    steps = {s.step for s in parts}
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in parts) / len(steps) / 1e6
