"""Share of the traced steps' wall time in which no operation ran on the
device: 100 less the union of the device operations' intervals over the
traced steps, set against the wall time of the same steps run again
untraced (host clock).  The host side of the profiler stretches a
launch-bound step; the device's busy time does not stretch with it."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops or not ctx.timed_wall_us:
        return None
    return 100.0 * (1.0 - t.busy_us / ctx.timed_wall_us)
