"""The card's busy time in the traced slice (the union of the profiler's
CUDA kernel, copy and set records) per statement completed in it."""


def read(ctx):
    sl = ctx.slice
    if sl is None:
        return None
    busy, _ = sl.busy()
    t0, t1 = (x - ctx.window_epoch for x in (sl.start_epoch, sl.stop_epoch))
    done = [s for s in ctx.completed() if t0 <= s.done <= t1]
    if not done or busy <= 0:
        return None
    return busy / 1e6 / len(done)
