"""Milliseconds a training step spends copying its batch to the device:
the mean of the program's `train.h2d` spans over the window's steps
outside the profiled ones (the profiler's start and stop take most of a
traced window, so few steps lie after it)."""

from portbench import spans


def read(ctx):
    h2d = spans.outside_train_steps(ctx, "train.h2d")
    if not h2d:
        return None
    return sum(s.end_ns - s.start_ns for s in h2d) / len(h2d) / 1e6
