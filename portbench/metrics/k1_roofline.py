"""Encoder attention K1's share of its roofline: the bound of the traced
batches' K1 calls (portbench/work.py, from the shapes and chunk lengths)
over K1's device time in the trace, in percent."""

from portbench import work

K1 = ("enc_attn_bf16", "enc_attn_f32", "enc_attn_any")


def read(ctx):
    trace, traced = ctx.get("trace"), ctx.get("traced_batches")
    if trace is None or not traced:
        return None
    calls, seconds = trace.time_of(*K1)
    if not calls or seconds <= 0:
        return None
    m = ctx["model"]
    bound = sum(work.k1_bound_s(m, ctx["samples"], ctx["batch_rows"], b["lengths"])
                for b in traced)
    return 100.0 * bound / seconds
