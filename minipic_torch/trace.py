"""Spans and counters of the step, kept in memory: where the host's time a
step goes, layer by layer, and every device value the step reads back, with
the profiler off.

    from minipic_torch import trace

    trace.enable()
    for i in range(1, n + 1):
        sim.run_step(i)
    trace.disable()
    spans, counters = trace.drain()

A span is ``(name, parent, start_ns, end_ns)``: `parent` is the index in the
same list of the span open around it (-1 for none); the times are
``time.time_ns()``, Unix-epoch nanoseconds, the clock of a profiler trace's
events (Kineto's ``start_ns()``), so the spans lie over a trace taken in the
same process.  Counters are ``{name: count}``.  Nothing is written until
``drain()``.

``read(value, site)`` is the one way the step turns a device value into a
host ``bool`` or ``int``: with the recorder on it counts ``host_reads`` and
``host_reads.<site>`` and spans ``step.read``.  It launches nothing and adds
no read.

The recorder is off by default.  Off, ``span`` costs a flag check (and, for a
layer span, whether a profiler runs), and ``read`` only converts.  The layer
spans, whose names begin with ``minipic.`` (``minipic.fields``,
``.advance``, ``.rebin``, ``.diag``, ``.parallel``), enter
``torch.profiler.record_function`` while a profiler runs, whether the
recorder is on or off: they are the ranges a profiler trace charges device
time to.  The other spans never enter one: a profiler range that holds
device work is also laid on the device's timeline as an annotation, which a
trace reader would take for a device operation.  So a span that is not a
layer never takes a ``minipic.`` name.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

LAYER_PREFIX = "minipic."
# The span of each read, and the counter of all reads.
READ_SPAN = "step.read"
READS = "host_reads"

Span = Tuple[str, int, int, int]

_NULL = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def _range(name: str):
    """A profiler range for a layer span while a profiler runs, else None."""
    if name.startswith(LAYER_PREFIX) and _profiling():
        return record_function(name)
    return None


class _Span:
    __slots__ = ("rec", "row", "range")

    def __init__(self, rec: "Recorder", name: str):
        self.rec = rec
        self.row = [name, rec.open[-1] if rec.open else -1, 0, 0]
        self.range = _range(name)

    def __enter__(self):
        rec = self.rec
        rec.open.append(len(rec.spans))
        rec.spans.append(self.row)
        # Stamped inside the profiler range, which then holds the span.
        if self.range is not None:
            self.range.__enter__()
        self.row[2] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.row[3] = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec.open.pop()
        return False


class Recorder:
    """The spans and counters of one process (the module's functions are
    the methods of one instance)."""

    def __init__(self):
        self.on = False
        self.spans: List[list] = []
        self.open: List[int] = []  # indices of the spans open, innermost last
        self.counters: Dict[str, int] = {}

    def span(self, name: str):
        """Context manager: a span `name` while the recorder is on; the
        profiler range of a layer span while a profiler runs."""
        if self.on:
            return _Span(self, name)
        r = _range(name)
        return _NULL if r is None else r

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            self.counters[name] = self.counters.get(name, 0) + n

    def read(self, value: torch.Tensor, site: str):
        """``value.item()``: a one-element device tensor on the host.  With
        the recorder on, counted under `site` and spanned."""
        if not self.on:
            return value.item()
        with _Span(self, READ_SPAN):
            out = value.item()
        self.count(READS)
        self.count(f"{READS}.{site}")
        return out

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def drain(self) -> Tuple[List[Span], Dict[str, int]]:
        """The spans and counters recorded since the last drain, which
        clears them.  Called between steps: no span may be open."""
        if self.open:
            raise RuntimeError(f"drain() inside the open span "
                               f"{self.spans[self.open[-1]][0]!r}")
        spans = [tuple(s) for s in self.spans]
        counters = self.counters
        self.spans, self.counters = [], {}
        return spans, counters


_recorder = Recorder()
span = _recorder.span
count = _recorder.count
read = _recorder.read
enable = _recorder.enable
disable = _recorder.disable
drain = _recorder.drain


def self_ns(spans: List[Span]) -> List[int]:
    """Each span's self time: its duration less its children's."""
    out = [end - start for _, _, start, end in spans]
    for _, parent, start, end in spans:
        if parent >= 0:
            out[parent] -= end - start
    return out


def by_name(spans: List[Span], steps: int
            ) -> Dict[str, Tuple[float, float, float]]:
    """{name: (calls a step, inclusive ms a step, self ms a step)} over
    `steps` steps, in the order of each name's first span."""
    tot: Dict[str, List[float]] = {}
    for (name, _, start, end), own in zip(spans, self_ns(spans)):
        t = tot.setdefault(name, [0, 0, 0])
        t[0] += 1
        t[1] += end - start
        t[2] += own
    return {name: (n / steps, incl / 1e6 / steps, own / 1e6 / steps)
            for name, (n, incl, own) in tot.items()}
