"""The 90th percentile (nearest rank) of the latency of every statement
sent in the window, from its send to its return, those that came back
after the close included (host clock). A statement that failed or never
came back counts as slower than every other."""
import math


def read(ctx):
    lat = sorted(math.inf if s.done is None or s.error is not None
                 else s.done - s.sent for s in ctx.statements)
    if not lat:
        return None
    p90 = lat[max(0, math.ceil(0.9 * len(lat)) - 1)]
    return None if math.isinf(p90) else 1000.0 * p90
