"""Seconds of the serving cell's warm-up run of the engine, part of its
set-up: the ingest pool's start, the kernels' first calls (their build on
a checkout's first run), and a full and a partial batch of every decode
stage."""


def read(ctx):
    return ctx.get("warmup_s")
