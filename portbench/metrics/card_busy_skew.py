"""The balance of the cards: the busiest card's busy time over the traced
steps (the union of its device operations' intervals) over the mean of the
cards' busy times.  1.0 is even; a run on one card reads nothing."""


def read(ctx):
    t = ctx.trace
    if t is None or len(t.busy_by_card) < 2:
        return None
    busy = [us for _, us in t.busy_by_card]
    mean = sum(busy) / len(busy)
    if mean <= 0:
        return None
    return max(busy) / mean
