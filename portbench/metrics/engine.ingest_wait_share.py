"""Share of the engine's wall the dispatching thread waited for the
ingest pipeline's next batch (io/pipeline.py), from the program's
StageTimer "ingest-wait" over "wall", in percent."""


def read(ctx):
    st = ctx.get("stages") or {}
    if "ingest-wait" not in st or not st.get("wall", {}).get("total_sec"):
        return None
    return 100.0 * st["ingest-wait"]["total_sec"] / st["wall"]["total_sec"]
