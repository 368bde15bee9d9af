"""Statements completed (without error) inside the window, divided by
the window (host clock)."""


def read(ctx):
    return len(ctx.completed()) / ctx.seconds
