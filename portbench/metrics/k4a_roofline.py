"""Decode attention K4a's share of its roofline (MHA cross attention,
one row a chunk): the bytes bound of the traced batches' K4a calls
(portbench/work.py, one a layer and decode step) over K4a's device time
in the trace, in percent."""

from portbench import work

K4A = ("decode_attn_row_kernel", "decode_attn_any_kernel")


def read(ctx):
    trace, traced = ctx.get("trace"), ctx.get("traced_batches")
    if trace is None or not traced:
        return None
    calls, seconds = trace.time_of(*K4A)
    if not calls or seconds <= 0:
        return None
    m = ctx["model"]
    bound = sum(work.k4a_bound_s(m, ctx["samples"], ctx["batch_rows"], b["lengths"],
                                 b["steps"]) for b in traced)
    return 100.0 * bound / seconds
