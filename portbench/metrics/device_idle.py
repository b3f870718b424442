"""Share of the traced window in which no operation ran on the device, in
percent (`device_idle.serve` in the serving cells, `device_idle.train` in
the training cell)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.n_device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
