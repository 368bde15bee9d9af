"""Share of the traced slice in which no CUDA record of the engine ran."""


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.seconds <= 0:
        return None
    busy, _ = sl.busy()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / 1e9 / sl.seconds)
