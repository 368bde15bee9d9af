"""Process start to the first timed statement: kernel build or load,
cache fills from the generators, the warm pass (host clock)."""


def read(ctx):
    return ctx.setup_s
