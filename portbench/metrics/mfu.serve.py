"""The model operations the traced batches needed (the configuration's
reference module's `serve_batch_flops`, from their shapes, chunk lengths
and served tokens) over the traced window at the H100's 989 TFLOP/s bf16
peak, in percent."""

from portbench import work


def read(ctx):
    trace, traced = ctx.get("trace"), ctx.get("traced_batches")
    if trace is None or not traced or trace.window_s <= 0 or not trace.n_device_ops:
        return None
    m, count = ctx["model"], ctx["reference"].serve_batch_flops
    flops = sum(count(m, ctx["samples"], b["lengths"], b["decoded"]) for b in traced)
    return 100.0 * flops / (trace.window_s * work.PEAK_BF16)
