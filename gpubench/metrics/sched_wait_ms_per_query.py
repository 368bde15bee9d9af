"""Time statements waited for the device in the fair scheduler (the
engine's ``sched-wait`` spans, ``exec/taskexec.py``), clipped to the
traced slice, per statement completed in it."""
from gpubench.harness.attribution import done_in_slice


def read(ctx):
    sl = ctx.slice
    if sl is None:
        return None
    waits = [min(s["end"], sl.stop_epoch) - max(s["start"], sl.start_epoch)
             for s in sl.spans if s["name"] == "sched-wait"]
    done = done_in_slice(ctx)
    if not waits or not done:
        return None
    return 1000.0 * sum(w for w in waits if w > 0) / len(done)
