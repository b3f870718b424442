"""Milliseconds a training step spends in the program's `train.h2d` span:
the mean over the window's steps outside the profiled ones (the
profiler's start and stop take most of a traced window, so few steps lie
after it).  On an eager step the span is the batch's copy to the device.
On a step replayed through its CUDA graph it is the wait for the staging
buffer's last copies, which the card reaches only after the replays
queued before them, and then the copy: there it reads the card's step
time as the host sees it, not the copy's cost."""

from portbench import spans


def read(ctx):
    h2d = spans.outside_train_steps(ctx, "train.h2d")
    if not h2d:
        return None
    return sum(s.end_ns - s.start_ns for s in h2d) / len(h2d) / 1e6
