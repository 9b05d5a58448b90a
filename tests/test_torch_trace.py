"""The port's recorder (minipic_torch/trace.py) on the CPU: nothing recorded
and no profiler range entered while it is off; with it on, every span of
the single-device step under its parent, the self times adding up to the
step, and the host reads counted by hand; under a CPU profiler the same
``minipic.*`` ranges as before, on the recorder's clock."""
import pathlib

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_torch import trace  # noqa: E402
from minipic_torch.core.config import Deck, SpeciesSpec  # noqa: E402
from minipic_torch.decks import standard  # noqa: E402
from minipic_torch.parallel.balance import (SHRINK_PATIENCE,  # noqa: E402
                                            CapacityManager)
from minipic_torch.simulation import Simulation  # noqa: E402

LAYERS = {"minipic.fields", "minipic.advance", "minipic.rebin",
          "minipic.diag"}
# Parent of each span name in the single-device step.
PARENT = {
    "step": None, "step.census": "step",
    **{n: "step" for n in LAYERS},
    **{f"fields.{n}": "minipic.fields"
       for n in ("tiles", "fold", "b_half", "e_full", "damping")},
    **{f"rebin.{n}": "minipic.rebin"
       for n in ("kill", "sort", "split", "segment", "route", "append",
                 "defrag")},
}
FIELDS = {"fields.tiles", "fields.fold", "fields.b_half", "fields.e_full"}
# The census is run_step's on step numbers that are multiples of 50.
STEPS = (49, 50, 51)
FORCED = 49


def _periodic(**kw):
    """bench.py's headline deck at 32^2 with 40 particles a cell (the deal
    route: 3072-slot buckets)."""
    base = dict(
        box_x=3.2, box_y=3.2, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=4,
        species=(SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=40, uth=0.1,
                             ux=0.05, shape_order=2),),
        precision="f32", capacity_headroom=1.1, kchunk=0, deposit="int8")
    base.update(kw)
    return Deck(**base)


def _calm(sim):
    """The capacity policy one calm census short of a shrink."""
    sim._capmgrs = [CapacityManager() for _ in sim.state.species]
    for m in sim._capmgrs:
        m._calm = SHRINK_PATIENCE - 1


# name: (simulation, the spans its steps must show, whether the census at
# step 50 shrinks the buckets)
DECKS = {
    # The deal route; buckets of 10240 slots, occupancy ~0.27: the census
    # shrinks them.
    "periodic": (lambda: Simulation(_periodic(tile_capacity=10240),
                                    device="cpu"),
                 FIELDS | {"rebin.split", "rebin.segment", "rebin.append",
                           "rebin.defrag"}, True),
    "periodic_sort": (lambda: Simulation(_periodic(
        rebin_mode="sort", species=(SpeciesSpec(
            "ele", charge=-1.0, mass=1.0, ppc=8, uth=0.1, ux=0.05,
            shape_order=2),)), device="cpu"), FIELDS | {"rebin.sort"}, False),
    # Absorbing walls, two species, 768-slot buckets: the small-bucket route.
    "laser_plasma": (lambda: standard.make(
        "laser_plasma", nx=32, ny=32, ppc=2).simulation(device="cpu"),
        FIELDS | {"fields.damping", "rebin.kill", "rebin.split",
                  "rebin.route", "rebin.append", "rebin.defrag"}, False),
}


def _steps(sim):
    """Steps STEPS through run_step, the re-bin forced at FORCED; returns
    the diags and the census's capacities before and after."""
    diags, caps = [], []
    for i in STEPS:
        if i == FORCED:
            sim.force_rebin()
        if i == 50:
            caps.append([p.capacity for p in sim.state.species])
        diags.append(sim.run_step(i))
        if i == 50:
            caps.append([p.capacity for p in sim.state.species])
    return diags, caps


@pytest.fixture(scope="module", params=sorted(DECKS))
def recorded(request):
    make, names, shrinks = DECKS[request.param]
    sim = make()
    sim.run_step(1)  # first calls outside the record
    if shrinks:
        _calm(sim)
    trace.drain()
    trace.enable()
    try:
        diags, caps = _steps(sim)
    finally:
        trace.disable()
    spans, counters = trace.drain()
    return dict(sim=sim, spans=spans, counters=counters, diags=diags,
                caps=caps, names=names, shrinks=shrinks)


def test_spans_nest_under_their_parents(recorded):
    spans = recorded["spans"]
    names = {s[0] for s in spans}
    assert recorded["names"] | LAYERS | {"step", "step.read",
                                        "step.census"} <= names
    assert names <= set(PARENT) | {"step.read"}
    assert sum(s[0] == "step" for s in spans) == len(STEPS)
    for name, parent, start, end in spans:
        assert end >= start
        if name == "step.read":
            assert spans[parent][0] in ("step", "step.census")
        elif PARENT[name] is None:
            assert parent == -1
        else:
            assert spans[parent][0] == PARENT[name]
        if parent >= 0:
            assert spans[parent][2] <= start and end <= spans[parent][3]


def test_self_times_add_up_to_the_step(recorded):
    spans = recorded["spans"]
    own = trace.self_ns(spans)
    assert min(own) >= 0
    # Siblings do not overlap.
    kids = {}
    for i, s in enumerate(spans):
        kids.setdefault(s[1], []).append(i)
    for ks in kids.values():
        for a, b in zip(ks, ks[1:]):
            assert spans[a][3] <= spans[b][2]

    def subtree(i):
        return own[i] + sum(subtree(k) for k in kids.get(i, []))

    for i, s in enumerate(spans):
        if s[0] == "step":
            assert subtree(i) == s[3] - s[2]


def test_host_reads_equal_a_hand_count(recorded):
    sim, counters = recorded["sim"], recorded["counters"]
    n_species = len(sim.state.species)
    diags = recorded["diags"]
    rebins = sum(d.rebinned for d in diags)
    assert rebins >= 1
    # run_step takes the census on step 50 and after a step that dropped.
    census = sum(i % 50 == 0 or (d.rebinned and int(d.overflow) > 0)
                 for i, d in zip(STEPS, diags))
    before, after = recorded["caps"]
    shrunk = after != before
    assert shrunk == recorded["shrinks"]
    want = {"host_reads.drift": len(STEPS),
            "host_reads.overflow": rebins,
            "host_reads.census": 2 * n_species * census,
            "host_reads.shrink": 2 if shrunk else 0}
    want["host_reads"] = sum(want.values())
    assert counters == {k: v for k, v in want.items() if v}
    assert sum(s[0] == "step.read" for s in recorded["spans"]) == \
        want["host_reads"]


def test_the_recorder_off_records_nothing_and_enters_no_range(monkeypatch):
    def no_range(name):
        raise AssertionError(f"profiler range {name!r} entered")

    monkeypatch.setattr(trace, "record_function", no_range)
    sim = DECKS["laser_plasma"][0]()
    trace.drain()
    sim.run_step(1)
    sim.force_rebin()
    sim.run_step(2)
    sim.step(1)
    assert trace.drain() == ([], {})
    # The recorder's module is the only one of the port that enters a
    # profiler range.
    pkg = pathlib.Path(trace.__file__).parent
    users = sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == ["trace.py"]


def test_simulation_step_spans_each_step():
    sim = DECKS["periodic_sort"][0]()
    trace.enable()
    try:
        sim.step(2)
    finally:
        trace.disable()
    spans, counters = trace.drain()
    assert [s[0] for s in spans if s[1] == -1] == ["step", "step"]
    assert counters == {"host_reads": 2, "host_reads.drift": 2}


def test_layer_ranges_under_the_profiler_lie_on_the_spans():
    """Under a CPU profiler: the ranges named minipic.* are today's four
    layers and no sub-span enters a range; each layer span lies inside its
    profiler range (one clock), and inside no other: each range ends before
    the next layer span begins.  How far a span's ends lie inside its
    range is the profiler's own cost, 4-100 us a range on an idle CPU and
    more on a loaded one, so no time is asserted."""
    from torch.profiler import ProfilerActivity, profile

    sim = DECKS["laser_plasma"][0]()
    sim.run_step(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run_step(2)  # the profiler's first ranges, left out below
        trace.drain()
        trace.enable()
        try:
            sim.force_rebin()
            sim.run_step(3)
            sim.run_step(4)
        finally:
            trace.disable()
    spans, _ = trace.drain()
    events = [(k.name(), k.start_ns(), k.end_ns())
              for k in prof.profiler.kineto_results.events()]
    assert {n for n, _, _ in events if n.startswith("minipic.")} == LAYERS
    assert not {n for n, _, _ in events} & (set(PARENT) - LAYERS)
    t0 = min(s[2] for s in spans)
    ranges = sorted((e for e in events if e[0] in LAYERS and e[1] >= t0),
                    key=lambda e: e[1])
    layer = sorted(((s[0], s[2], s[3]) for s in spans if s[0] in LAYERS),
                   key=lambda e: e[1])
    assert len(ranges) == len(layer) > 0
    for (rn, rs, re_), (sn, ss, se) in zip(ranges, layer):
        assert rn == sn
        assert rs <= ss and se <= re_
    for (_, _, re_), (_, ss, _) in zip(ranges, layer[1:]):
        assert re_ <= ss


def test_drain_refuses_an_open_span_and_by_name_sums_a_step():
    trace.enable()
    try:
        with trace.span("step"):
            with pytest.raises(RuntimeError, match="step"):
                trace.drain()
    finally:
        trace.disable()
    trace.drain()
    spans = [("step", -1, 0, 10_000_000), ("minipic.fields", 0, 1_000_000,
                                           4_000_000),
             ("fields.fold", 1, 2_000_000, 3_000_000),
             ("step", -1, 20_000_000, 26_000_000)]
    assert trace.self_ns(spans) == [7_000_000, 2_000_000, 1_000_000,
                                    6_000_000]
    assert trace.by_name(spans, 2) == {"step": (1.0, 8.0, 6.5),
                                       "minipic.fields": (0.5, 1.5, 1.0),
                                       "fields.fold": (0.5, 0.5, 0.5)}
