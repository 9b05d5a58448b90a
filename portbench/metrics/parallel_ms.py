"""Device milliseconds a traced step of the operations launched inside
``minipic.parallel`` (the mesh's hand-offs between cards: the J sum, the
reductions, the movers' gather and route, the copies to the first card),
summed over the cards and amortised over every traced step."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    us = t.range_us("minipic.parallel")
    if us <= 0:
        return None
    return us / 1e3 / t.steps
