"""Reading a profiler trace of the window: which device operation ran when,
under which range of the program the host launched it, how much of the
traced wall time the device was busy, and what the host was doing while it
was idle.

A device operation is charged to the innermost range (``minipic.advance``,
``.fields``, ``.rebin``, ``.diag``, the harness's ``portbench.step`` and
``portbench.restart``) open on the host when it was launched: the profiler
links each kernel to the host operation that launched it.  Where it does
not, the operation is charged to the device-side span of the range that
holds it (one stream a card: a range's kernels run in a row).  Busy time
is the union of the device operations' intervals on each card (the port's
``headline.py`` ``_busy_us``, copied), averaged over the cards the run
uses; an idle gap of a card is labelled by the innermost range and host
operation open at its middle, and the gaps are averaged over the cards
alike.  With one card every number is that card's.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

HARNESS_RANGES = ("portbench.step", "portbench.restart")


def _is_range(name: str) -> bool:
    return name.startswith("minipic.") or name in HARNESS_RANGES


def is_kernel(name: str) -> bool:
    """A kernel, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class DeviceOp(NamedTuple):
    name: str
    start: float  # us
    end: float
    range: str  # innermost range at launch ("" outside every range)
    card: int = 0  # the card it ran on


class TraceSummary(NamedTuple):
    ops: Tuple[DeviceOp, ...]
    steps: int
    wall_us: float
    busy_us: float  # the mean over the cards of each card's busy time
    busy_by_card: Tuple[Tuple[int, float], ...]  # (card, busy us)
    linked_share: float  # share of device ops linked to their launch
    # share of the linked ones that the device-side range spans charge to
    # the same range
    span_agreement: float
    idle_gaps: Tuple[Tuple[str, float], ...]  # (label, us), largest first

    def range_us(self, name: str) -> float:
        """Device time of the operations charged to range `name`."""
        return sum(o.end - o.start for o in self.ops if o.range == name)

    def kernels(self) -> int:
        return sum(1 for o in self.ops if is_kernel(o.name))

    def by_name(self) -> List[Tuple[str, float]]:
        """(device op name, us) summed by name, largest first."""
        tot: Counter = Counter()
        for o in self.ops:
            tot[o.name] += o.end - o.start
        return tot.most_common()


def busy_us(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of the intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def merged(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def innermost(intervals: Sequence[Tuple[float, float, str]],
              queries: Sequence[float]) -> List[str]:
    """For each query time, the label of the innermost of the (nested or
    disjoint) intervals holding it, "" where none does."""
    ivs = sorted(intervals, key=lambda t: (t[0], -t[1]))
    order = sorted(range(len(queries)), key=lambda i: queries[i])
    out = [""] * len(queries)
    stack: List[Tuple[float, float, str]] = []
    k = 0
    for qi in order:
        t = queries[qi]
        while k < len(ivs) and ivs[k][0] <= t:
            while stack and stack[-1][1] <= ivs[k][0]:
                stack.pop()
            stack.append(ivs[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[qi] = stack[-1][2] if stack else ""
    return out


class Event(NamedTuple):
    """What the reader needs of a profiler event."""

    name: str
    start: float
    end: float
    on_device: bool
    thread: int
    id: int
    linked_id: int
    card: int = 0  # the device index of a device event


def events_of(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``, read from its
    raw Kineto results, which carry each device operation's link to the
    host operation that launched it."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        raise RuntimeError("the profiler kept no Kineto results")
    return [Event(k.name(), k.start_ns() / 1e3, k.end_ns() / 1e3,
                  k.device_type() == cuda, k.start_thread_id(),
                  k.correlation_id(), k.linked_correlation_id(),
                  k.device_index())
            for k in raw.events() if k.name() != "[memory]"]


def summarize(events: Sequence[Event], steps: int, wall_us: float,
              host_thread: Optional[int] = None,
              cards: Sequence[int] = ()) -> TraceSummary:
    """The summary of a traced window of `steps` steps, `wall_us` long.
    `host_thread`: the thread that ran the steps (default: the one that
    opened the most ``portbench.step`` ranges).  `cards`: the cards the run
    used (default: those the device events name); a device event on
    another index is charged to the first of them."""
    host = [e for e in events if not e.on_device]
    if host_thread is None:
        counts = Counter(e.thread for e in host if e.name == "portbench.step")
        host_thread = counts.most_common(1)[0][0] if counts else None
    main = [e for e in host if e.thread == host_thread]
    ranges = [(e.start, e.end, e.name) for e in main if _is_range(e.name)]
    by_id = {e.id: e for e in host if e.linked_id == 0}
    cards = list(cards) or sorted({e.card for e in events if e.on_device})
    cards = cards or [0]

    def card(e):
        return e.card if e.card in cards else cards[0]

    dev = [e for e in events if e.on_device and not _is_range(e.name)]
    launched = [by_id.get(e.linked_id) if e.linked_id else None for e in dev]
    linked = [i for i, h in enumerate(launched) if h is not None]
    loose = [i for i, h in enumerate(launched) if h is None]
    labels = [""] * len(dev)
    for i, lab in zip(linked, innermost(
            ranges, [launched[i].start for i in linked])):
        labels[i] = lab
    by_span = [""] * len(dev)
    for c in cards:
        mine = [i for i, e in enumerate(dev) if card(e) == c]
        dev_spans = [(e.start, e.end, e.name) for e in events
                     if e.on_device and _is_range(e.name) and card(e) == c]
        for i, lab in zip(mine, innermost(dev_spans,
                                          [dev[i].start for i in mine])):
            by_span[i] = lab
    for i in loose:
        labels[i] = by_span[i]
    agree = sum(labels[i] == by_span[i] for i in linked)
    ops = [DeviceOp(e.name, e.start, e.end, lab, card(e))
           for e, lab in zip(dev, labels)]
    busy = tuple((c, busy_us([(o.start, o.end) for o in ops if o.card == c]))
                 for c in cards)
    idle: Counter = Counter()
    for c in cards:
        spans = merged([(o.start, o.end) for o in ops if o.card == c])
        gaps = [(a, b) for (_, a), (b, _) in zip(spans, spans[1:])]
        labels = innermost([(e.start, e.end, e.name) for e in main],
                           [(a + b) / 2 for a, b in gaps])
        range_of = innermost(ranges, [(a + b) / 2 for a, b in gaps])
        for (a, b), lab, rng in zip(gaps, labels, range_of):
            key = lab if lab == rng or not rng else f"{rng} > {lab}"
            idle[key or "(no host range)"] += (b - a) / len(cards)
    return TraceSummary(
        ops=tuple(ops), steps=steps, wall_us=wall_us,
        busy_us=sum(us for _, us in busy) / len(cards), busy_by_card=busy,
        linked_share=len(linked) / len(dev) if dev else 0.0,
        span_agreement=agree / len(linked) if linked else 0.0,
        idle_gaps=tuple(idle.most_common()))


def breakdown(s: TraceSummary, top: int = 10) -> Dict[str, list]:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle time by what the host was doing, in
    seconds over the traced window."""
    return {
        "device_ops": [[n[:160], t / 1e6] for n, t in s.by_name()[:top]],
        "idle_gaps": [[n[:160], t / 1e6] for n, t in s.idle_gaps[:top]],
    }
