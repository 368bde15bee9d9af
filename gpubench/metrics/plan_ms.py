"""Mean length of the engine's ``plan`` spans (``exec/runner.py``: the
plan cache's lookup, or planning on a miss) in the traced slice."""


def read(ctx):
    if ctx.slice is None:
        return None
    spans = [s["end"] - s["start"] for s in ctx.slice.spans
             if s["name"] == "plan"]
    return 1000.0 * sum(spans) / len(spans) if spans else None
