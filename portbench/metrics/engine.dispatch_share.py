"""Share of the engine's wall spent dispatching batches (encode and
decode of a batch on the dispatching thread), from the program's
StageTimer "dispatch" over "wall", in percent."""


def read(ctx):
    st = ctx.get("stages") or {}
    if "dispatch" not in st or not st.get("wall", {}).get("total_sec"):
        return None
    return 100.0 * st["dispatch"]["total_sec"] / st["wall"]["total_sec"]
