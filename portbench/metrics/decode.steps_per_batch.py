"""Decode steps a batch over the run (the program's Translator counters
`decode_steps` over `batches`): the straggler cost of the staged loop,
which runs until the batch's longest chunk ends."""


def read(ctx):
    batches = ctx.get("batches")
    if not batches:
        return None
    return sum(b["steps"] for b in batches) / len(batches)
