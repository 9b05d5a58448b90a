"""The advance's share of its roofline: the least time of one step's
advance (``portbench.roofline``: bytes over 3.35 TB/s or operations over
the published peak, whichever is larger) over the device time of the
operations launched inside ``minipic.advance``, a traced step."""
from .. import roofline


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps or not ctx.traced_live:
        return None
    dev_us = t.range_us("minipic.advance") / t.steps
    if dev_us <= 0:
        return None
    deck = ctx.deck
    least = roofline.advance_least_s(
        ctx.traced_live, deck["nx"], deck["ny"],
        8 if deck["precision"] == "f64" else 4)
    return 100.0 * least * 1e6 / dev_us
