"""Milliseconds a step: the window's wall time (host clock, closed by a
synchronize) over its steps, restarts of the deck included."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.wall_s * 1e3 / ctx.steps
