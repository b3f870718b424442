"""The forward and backward operations of the traced steps (the
configuration's reference module's `train_step_flops`, from the batch
shape) over the traced window at the H100's 67 TFLOP/s float32 peak (the
configuration trains in float32 with TF32 off), in percent."""

from portbench import work


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("steps_traced") or not trace.n_device_ops:
        return None
    flops = ctx["steps_traced"] * ctx["reference"].train_step_flops(
        ctx["model"], ctx["batch_rows"], ctx["samples"], ctx["model"]["max_decode_len"])
    return 100.0 * flops / (trace.window_s * work.PEAK_F32)
