"""Device memory the statements took over the resident cache: the
allocator's peak over the window less what was allocated at its start."""


def read(ctx):
    if ctx.query_mem_bytes is None:
        return None
    return ctx.query_mem_bytes / 2 ** 30
