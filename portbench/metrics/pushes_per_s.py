"""Particle pushes a second: the live particles of every step of the window
summed, over the window's wall time (host clock, the window closed by a
synchronize)."""


def read(ctx):
    if not ctx.steps or ctx.wall_s <= 0:
        return None
    return ctx.live_sum / ctx.wall_s
