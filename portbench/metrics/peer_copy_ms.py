"""Device milliseconds a traced step of the copies between cards, summed
over the cards: the profiler's ``Memcpy PtoP`` operations (one card to
another, over NVLink where peer access is on, staged through the host by
CUDA where it is off), wherever the host launched them."""

PEER = "Memcpy PtoP"


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    us = sum(o.end - o.start for o in t.ops if o.name.startswith(PEER))
    if us <= 0:
        return None
    return us / 1e3 / t.steps
