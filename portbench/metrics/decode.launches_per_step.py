"""Device operations in the traced window over the decode steps of the
batches traced: the host's dispatch work a step."""


def read(ctx):
    trace, traced = ctx.get("trace"), ctx.get("traced_batches")
    steps = sum(b["steps"] for b in traced or [])
    if trace is None or not steps or not trace.n_device_ops:
        return None
    return trace.n_device_ops / steps
