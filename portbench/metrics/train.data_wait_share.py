"""Share of the training window the step loop waited on the program's
`prefetch_batches` (train/data.py) for its next batch, in percent."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["data_wait_s"] / ctx["window_s"]
