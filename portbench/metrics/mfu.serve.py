"""The model operations the traced batches needed (portbench/work.py,
from their shapes, chunk lengths and served tokens) over
the traced window at the H100's 989 TFLOP/s bf16 peak, in percent."""

from portbench import work


def read(ctx):
    trace, traced = ctx.get("trace"), ctx.get("traced_batches")
    if trace is None or not traced or trace.window_s <= 0 or not trace.n_device_ops:
        return None
    m = ctx["model"]
    flops = sum(work.serve_batch_flops(m, ctx["samples"], b["lengths"], b["decoded"])
                for b in traced)
    return 100.0 * flops / (trace.window_s * work.PEAK_BF16)
