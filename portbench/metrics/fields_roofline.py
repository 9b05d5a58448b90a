"""The field update's share of its roofline: the least time of one step's
field update (``portbench.roofline``: E and B read and written once, J read
where the deck has species, over 3.35 TB/s) over the device time of the
operations launched inside ``minipic.fields``, a traced step."""
from .. import roofline


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    dev_us = t.range_us("minipic.fields") / t.steps
    if dev_us <= 0:
        return None
    deck = ctx.deck
    least = roofline.fields_least_s(
        deck["nx"], deck["ny"], 8 if deck["precision"] == "f64" else 4,
        bool(deck["species"]))
    return 100.0 * least * 1e6 / dev_us
