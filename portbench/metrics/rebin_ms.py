"""Device milliseconds a traced step of the operations launched inside
``minipic.rebin``, amortised over every traced step."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    us = t.range_us("minipic.rebin")
    if us <= 0:
        return None
    return us / 1e3 / t.steps
