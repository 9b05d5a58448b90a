"""One run of one cell: set-up, warm-up, the measured window, the traced
window and the check against the reference.

Everything a cell is sits in files that the harness finds by name:

* ``workloads/<cell>.json``: the configuration, the precision and deposit,
  the restart policy, the warm-up, the traced steps and the limits of the
  numbers compared;
* ``configs/<config>.json``: the deck's fields (sizes, species with their
  density profiles, boundary), its initial fields, its source;
* ``metrics/<name>.py``: one reader a metric (``metrics/__init__.py``).

The program is driven only through ``minipic_torch``'s ``Deck``,
``SpeciesSpec`` and its simulations' ``run_step`` (the path of the command
line and of ``run``): ``Simulation`` on one device, or, as the workload's
``layout`` says, the mesh simulations ``ShardedSimulation`` (block
placement) and ``BalancedSimulation`` (striped placement) with their shards
round-robin over the cell's cards.  The harness holds every state it makes
or judges in natural tile order (bucket t is tile t, row-major); a mesh
simulation keeps its buckets in its storage order
(``storage_permutation()``), so the inputs go in through that permutation
and what the check reads comes out through it.  A deck may have no
species (fields only), or a moving window (judged on one device).  The
inputs are the benchmark's own (``inputs.py``); the reference
(``reference/``) imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import importlib
import itertools
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

from . import inputs
from .reference import compare as cmp
from .reference import step as ref_step
from .reference import window as ref_window
from .trace import TraceSummary, breakdown, events_of, summarize

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"
# Steps after the window within which a check waits for a natural re-bin
# before it forces one.
_REBIN_WAIT = 100
# Steps whose live counts the window keeps on the device before it sums
# them.  Each count holds a block of the allocator (512 bytes): past this
# many steps the harness's own memory (8 MB) no longer grows with the
# window's steps, so a window of tens of thousands of short steps reads the
# same peak in every run; a shorter window holds all its counts.
_LIVE_FOLD = 16384
# The workload's ``layout``: the program's simulation that runs the deck.
LAYOUTS = ("single", "sharded", "balanced")
# The type of a deck's stated precision.
PRECISION = {"f32": torch.float32, "f64": torch.float64}
# The steps a workload's ``judge`` may name (``judged_steps``).
JUDGE_KINDS = ("last", "rebin", "capacity", "shift", "start")


def check_cell(deck: dict, workload: dict) -> None:
    """Refuse at load what a run could not judge: an unknown judge kind, a
    re-bin or a capacity change awaited on a deck without particles, a
    shift on a deck without a moving window, a moving window laid over a
    mesh."""
    for kind in workload["judge"]:
        if kind not in JUDGE_KINDS:
            raise ValueError(f"judge {kind!r}: one of {JUDGE_KINDS}")
        if kind in ("rebin", "capacity") and not deck["species"]:
            raise ValueError(f"judge {kind!r} waits for particles: the "
                             "deck has no species")
        if kind == "shift" and not deck.get("moving_window"):
            raise ValueError("judge 'shift' needs a moving window")
    if (deck.get("moving_window")
            and workload.get("layout", "single") != "single"):
        raise ValueError("the harness judges a moving window on one device "
                         "only")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(cell: str):
    """(workload, configuration) of cell `cell`."""
    workload = load_json(ROOT / "workloads" / f"{cell}.json")
    config = load_json(ROOT / "configs" / f"{workload['config']}.json")
    return workload, config


def deck_dict(config: dict, workload: dict) -> dict:
    """The configuration's deck with the cell's precision and deposit."""
    deck = dict(config["deck"])
    deck["precision"] = workload["precision"]
    deck["deposit"] = workload["deposit"]
    return deck


def build_deck(deck: dict):
    """The port's ``Deck`` of a deck dict."""
    from minipic_torch.core.config import Deck, SpeciesSpec

    species = tuple(
        SpeciesSpec(**{k: v for k, v in sp.items() if k != "density"},
                    density=inputs.density_profile(sp.get("density")))
        for sp in deck["species"])
    fields = {f.name for f in dataclasses.fields(Deck)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in deck.items() if k in fields and k != "species"}
    return Deck(species=species, **kw)


def cell_chips(bench: dict, cell: str) -> int:
    """The cards cell `cell` asks for in BENCHMARK.json (1 where it has no
    entry there)."""
    for w in bench["workloads"]:
        if w["name"] == cell:
            return int(w["chips"])
    return 1


def mesh_devices(deck, device: torch.device, chips: int) -> list:
    """The devices of a mesh simulation's shards: the deck's ``mesh_shape``
    shards round-robin over cards 0..chips-1, or all on `device` when it is
    not a card."""
    if deck.mesh_shape is None:
        raise ValueError("a mesh layout needs the deck's mesh_shape")
    n = deck.mesh_shape[0] * deck.mesh_shape[1]
    if device.type != "cuda":
        return [device] * n
    return [torch.device("cuda", s % chips) for s in range(n)]


@dataclasses.dataclass
class RunContext:
    """What the metric readers read."""

    cell: str
    workload: dict
    deck: dict
    setup_s: float = 0.0
    steps: int = 0
    wall_s: float = 0.0
    live_sum: float = 0.0
    peak_bytes: Optional[int] = None
    trace: Optional[TraceSummary] = None
    # host-clock wall time of the traced steps run again untraced
    timed_wall_us: Optional[float] = None
    traced_live: Dict[int, float] = dataclasses.field(default_factory=dict)


def read_metrics(entries: List[dict], ctx: RunContext) -> Dict[str, dict]:
    """{name: {value, unit}} of each metric entry whose reader finds
    something to read."""
    out = {}
    for m in entries:
        reader = importlib.import_module(
            f"{__package__}.metrics.{m['name'].split('.')[0]}")
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metric entries cell `cell` reports: end to end with --trace 0,
    per layer with --trace 1 (those listing the cell)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


class Sim:
    """The program's simulation with the cell's inputs and its restart.

    ``held()`` is the program's state as it holds it (no copy): the
    ``SimState`` of ``Simulation``, or the per-shard ``shard_state`` of a
    mesh simulation, in its storage order.  ``natural(state)`` reads such a
    state, or one the harness made, in natural tile order."""

    def __init__(self, deck: dict, config: dict, workload: dict, seed: int,
                 device, chips: int = 1):
        from minipic_torch.core.state import (FieldState, ParticleState,
                                              SimState)
        from minipic_torch.simulation import Simulation

        self.deck = deck
        self.workload = workload
        self.seed = seed
        self.device = torch.device(device)
        if workload["entry"] != "run_step":
            raise ValueError(f"entry {workload['entry']!r}: the harness "
                             "drives the simulation's run_step")
        layout = workload.get("layout", "single")
        if layout not in LAYOUTS:
            raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
        check_cell(deck, workload)
        pdeck = build_deck(deck)
        self.total_steps = pdeck.total_steps
        self._types = FieldState, ParticleState, SimState
        # The program loads its own particles; the cell's are the
        # benchmark's, made from the seed.
        if layout == "single":
            sim = Simulation(pdeck, seed=0, device=self.device)
            self.devices = [self.device]
            self.perm = None
            self.capacities = [p.capacity for p in sim.state.species]
            self._window_x0 = sim.state.window_x0
            sim.state = sim.state._replace(species=())
        else:
            from minipic_torch.parallel.balanced import BalancedSimulation
            from minipic_torch.parallel.step import ShardedSimulation

            cls = (ShardedSimulation if layout == "sharded"
                   else BalancedSimulation)
            sim = cls(pdeck, seed=0,
                      devices=mesh_devices(pdeck, self.device, chips))
            self.devices = sim.mesh.distinct()
            # perm[storage row] = natural tile id
            self.perm = torch.as_tensor(sim.storage_permutation(),
                                        device=self.device)
            st = sim.shard_state
            self.capacities = [p.capacity for p in st.species[0]]
            self._window_x0 = None
            sim.shard_state = st._replace(species=[() for _ in st.species])
            st = None
        self.sim = sim
        self.periodic = ref_step.geometry(deck).periodic
        initial = self.make_initial(config)
        self.n_inputs = sum(int((p.w > 0).sum()) for p in initial.species)
        # overflow_total when the state was last set to the inputs
        self.ovf_base = 0
        initial = self.to_storage(initial)
        self.initial = initial if workload["restart"] == "deck" else None
        sim.state = initial

    def make_initial(self, config: dict):
        dtype = PRECISION[self.deck["precision"]]
        field_t, particle_t, state_t = self._types
        gen = inputs.seeded_generator(self.seed, self.device)
        species = tuple(
            particle_t(*inputs.load_species(
                sp, self.deck, cap, gen, dtype, self.device))
            for sp, cap in zip(self.deck["species"], self.capacities))
        fields = field_t(*inputs.init_fields(
            config["fields"], self.deck, dtype, self.device))
        return state_t(
            fields=fields, species=species,
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            drift=torch.zeros((), dtype=torch.float32, device=self.device),
            window_x0=self._window_x0)

    def to_storage(self, state):
        """A state made in natural tile order, its buckets put in the
        simulation's storage order."""
        if self.perm is None:
            return state
        return state._replace(species=tuple(
            self._types[1](*(a.index_select(0, self.perm) for a in p))
            for p in state.species))

    def held(self):
        """The program's state as it holds it (no copy)."""
        return self.sim.state if self.perm is None else self.sim.shard_state

    def hold(self, state) -> None:
        """Set the program's state as it holds it (``held``'s form)."""
        if self.perm is None:
            self.sim.state = state
        else:
            self.sim.shard_state = state

    def natural(self, state):
        """(each species' live particles as ``reference.step.Flat`` with the
        natural id of the tile each sits in, the six global fields, the
        accumulated drift) of a state the harness made (a ``SimState`` in
        natural order) or one the program held (``held()``)."""
        if not isinstance(state, self._types[2]):
            # The mesh's own global view, in storage order, on its first
            # device: the buckets' rows map back through the permutation.
            now = self.sim.shard_state
            self.sim.shard_state = state
            try:
                state = self.sim.state
            finally:
                self.sim.shard_state = now
            species = tuple(
                f._replace(tile=self.perm[f.tile])
                for f in (ref_step.flatten(tuple(p)) for p in state.species))
        else:
            species = tuple(ref_step.flatten(tuple(p))
                            for p in state.species)
        return species, tuple(state.fields), float(state.drift)

    def clock(self, state):
        """(step, window_x0) of a one-device state of a moving window, read
        to the host; None for any other deck."""
        if not self.deck.get("moving_window"):
            return None
        return int(state.step), int(state.window_x0)

    def live_counts(self) -> List[float]:
        """Each species' live particles now, over every shard."""
        shards = ([self.sim.state.species] if self.perm is None
                  else self.sim.shard_state.species)
        return [float(sum(int((sp[i].w > 0).sum()) for sp in shards))
                for i in range(len(shards[0]))]

    def restart(self, state=None) -> None:
        """Back to the initial state (kept, or `state`, made in natural
        order), with the capacity policy's memory cleared as a new
        simulation has it.  The program offers no public reset: its
        managers sit in ``_capmgrs``, and the restart fails rather than set
        an attribute the program no longer reads."""
        with record_function("portbench.restart"):
            if not hasattr(self.sim, "_capmgrs"):
                raise AttributeError(
                    "the simulation's _capmgrs is gone: the restart cannot "
                    "clear the capacity policy")
            self.sim.state = (self.initial if state is None
                              else self.to_storage(state))
            self.sim._capmgrs = None
            self.ovf_base = self.sim.overflow_total

    def expected_live(self) -> int:
        """Live particles after a step of a periodic deck: the inputs' less
        what re-bins dropped and counted since they were set."""
        return self.n_inputs - (self.sim.overflow_total - self.ovf_base)

    def step(self, i: int):
        with record_function("portbench.step"):
            return self.sim.run_step(i)

    def force_rebin(self) -> None:
        st = self.held()
        self.hold(st._replace(drift=torch.full_like(st.drift, float("inf"))))

    def sync(self) -> None:
        """Wait for every card the simulation uses."""
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def peak_bytes(self) -> int:
        """``max_memory_allocated`` of the fullest card used."""
        return max(torch.cuda.max_memory_allocated(d) for d in self.devices)


class Judged(NamedTuple):
    """A step the check judges."""

    prev: object  # the state the reference steps from (``Sim.natural``)
    cur: object  # the program's state after the step, as it held it
    diag: object  # the program's StepDiag of the step
    relaid: bool  # the capacity policy changed the buckets after the step


class Window(NamedTuple):
    steps: int
    wall_s: float
    live_sum: float
    # the window's live particles summed against the inputs' count less
    # what re-bins dropped and counted (periodic decks; None between walls)
    live_off: Optional[float]
    last: Judged  # the window's last step
    next_i: int


def drive(sim: Sim, seconds: float, i: int, on_step=None,
          min_steps: int = 0) -> Window:
    """Step through ``run_step`` for `seconds` (and at least `min_steps`
    steps), numbering from `i + 1` and restarting the deck past its last
    step when the cell says so.  No synchronize but the one that closes it;
    the live counts stay on the device until then, summed every _LIVE_FOLD
    steps.  `on_step(k)` is called before step k of the window (k from
    0)."""
    lives, live_sum = [], 0
    total = sim.total_steps
    restart = sim.workload["restart"] == "deck"
    prev = diag = None
    n = rebins = expect = 0
    t0 = time.perf_counter()
    marks = [(t0, time.thread_time())]
    while True:
        if on_step is not None:
            on_step(n)
        i += 1
        if restart and i > total:
            marks.append((time.perf_counter(), time.thread_time()))
            sim.restart()
            i = 1
        prev, changes = sim.held(), sim.sim.capacity_changes
        diag = sim.step(i)
        lives.append(diag.shard_live)
        if len(lives) == _LIVE_FOLD:
            live_sum = live_sum + torch.cat(lives).sum()
            lives = []
        if sim.periodic:
            expect += sim.expected_live()
        n += 1
        rebins += diag.rebinned
        if n >= min_steps and time.perf_counter() - t0 >= seconds:
            break
    sim.sync()
    wall = time.perf_counter() - t0
    if lives:
        live_sum = live_sum + torch.cat(lives).sum()
    live = float(live_sum)
    passes = " ".join(
        f"{(b[0] - a[0]) * 1e3 / total:.3f} ({(b[1] - a[1]) * 1e3 / total:.3f})"
        for a, b in zip(marks, marks[1:]))
    print(f"window: {n} steps in {wall:.3f} s, {rebins} re-bins, capacity "
          f"changes {sim.sim.capacity_changes}"
          + (f", ms/step of each whole deck (host thread's CPU ms/step) "
             f"{passes}" if passes else ""), file=sys.stderr)
    last = Judged(prev, sim.held(), diag,
                  sim.sim.capacity_changes != changes)
    return Window(n, wall, live, abs(live - expect) if sim.periodic else None,
                  last, i)


def warm_up(sim: Sim) -> int:
    """The cell's warm-up through ``run_step``, numbered from 1; returns
    the number of the last step taken (0 after a restart)."""
    w = sim.workload["warmup"]
    steps = sim.total_steps if w["steps"] == "deck" else int(w["steps"])
    for i in range(1, steps + 1):
        if i == w["force_rebin"]:
            sim.force_rebin()
        sim.step(i)
    if sim.workload["restart"] == "deck":
        sim.restart()
        steps = 0
    sim.sync()
    return steps


def produced(sim: Sim, state, diag, relaid: bool) -> cmp.Produced:
    """The program's step as the judged side."""
    species, fields, drift = sim.natural(state)
    return cmp.Produced(
        species=species, fields=fields,
        field_energy=float(diag.field_energy),
        kinetic=tuple(float(v) for v in diag.kinetic_energy),
        momentum=tuple(tuple(float(v) for v in m) for m in diag.momentum),
        live=int(diag.shard_live.sum()),
        overflow=int(diag.overflow) if diag.rebinned else 0,
        rebinned=bool(diag.rebinned), drift=drift, relaid=relaid)


def reference_of(sim: Sim, prev, deck: dict,
                 dtype=None) -> ref_step.Result:
    """The reference's step from state `prev`, in the deck's precision
    (`dtype`: another)."""
    dtype = PRECISION[deck["precision"]] if dtype is None else dtype
    species, fields, drift = sim.natural(prev)
    return ref_step.step(species, fields, drift, deck,
                         cmp.expected_modes(deck), dtype=dtype,
                         clock=sim.clock(prev))


def judged_steps(sim: Sim, last: Judged, next_i: int, config: dict):
    """The steps the check judges, one at a time, in the order of the
    workload's ``judge``:

    * ``last``: the window's last step;
    * ``rebin``: the first step after it that re-bins (forced after
      _REBIN_WAIT steps without one);
    * ``capacity``: the first step after that in which the capacity policy
      changes the buckets (within a deck's steps; none may come);
    * ``shift``: the first step after that which shifts the moving window,
      as the reference's predicate has it from the state stepped from (a
      step that should shift and does not is the one judged);
    * ``start``: the first step from the cell's inputs: after the window's
      own restart from the kept state where the cell restarts, else from
      the inputs made again.  The reference steps from the inputs made
      again from the seed after the program's step, so that nothing the
      program did to the kept state reaches it.

    The others step from the program's state before the step."""
    restart = sim.workload["restart"] == "deck"
    i = next_i

    def one():
        nonlocal i
        i += 1
        if restart and i > sim.total_steps:
            sim.restart()
            i = 1
        changes, prev = sim.sim.capacity_changes, sim.held()
        diag = sim.step(i)
        return Judged(prev, sim.held(), diag,
                      sim.sim.capacity_changes != changes)

    for kind in sim.workload["judge"]:
        rec = None
        if kind == "last":
            rec, last = last, None
        elif kind == "rebin":
            for k in itertools.count():
                if k == _REBIN_WAIT:
                    sim.force_rebin()
                rec = one()
                if rec.diag.rebinned:
                    break
        elif kind == "capacity":
            for _ in range(sim.total_steps + 1):
                rec = one()
                if rec.relaid:
                    break
            else:
                rec = None
                print(f"check: no capacity change in {sim.total_steps + 1} "
                      "steps", file=sys.stderr)
        elif kind == "shift":
            for _ in range(sim.total_steps + 1):
                rec = one()
                if ref_window.shift_now(*sim.clock(rec.prev), sim.deck):
                    break
            else:
                raise RuntimeError(f"no window shift in "
                                   f"{sim.total_steps + 1} steps")
        elif kind == "start":
            sim.hold(None)  # freed before the inputs are made again
            sim.restart(None if restart else sim.make_initial(config))
            i = 0
            rec = one()
            # The program's state before the step is let go; the
            # reference's inputs are made after the step, out of its reach.
            rec = rec._replace(prev=None)
            rec = rec._replace(prev=sim.make_initial(config))
        else:
            raise ValueError(f"judge {kind!r}")
        if rec is not None:
            yield rec
        rec = None


# The precision below each one a deck can state: the control's.
CONTROL_DTYPE = {"f32": torch.bfloat16, "f64": torch.float32}


def step_readings(sim: Sim, last: Judged, next_i: int, config: dict,
                  sides=("program",)):
    """The numbers compared for each step of ``judged_steps``, one dict a
    step: {side: reading}.  Side "program" judges the program's step;
    "control" the reference in the precision below the deck's, put in the
    program's place."""
    deck = sim.deck
    geo = ref_step.geometry(deck)
    for rec in judged_steps(sim, last, next_i, config):
        ref = reference_of(sim, rec.prev, deck)
        out = {}
        for side in sides:
            if side == "control":
                prod = cmp.from_result(reference_of(
                    sim, rec.prev, deck, CONTROL_DTYPE[deck["precision"]]),
                    geo)
            else:
                prod = produced(sim, rec.cur, rec.diag, rec.relaid)
            out[side] = cmp.compare(prod, ref, deck)
            prod = None
        rec = ref = None
        yield out


def check(sim: Sim, window: Window, config: dict, limits: Dict[str, float],
          control: bool = False):
    """Judge the window's live count (periodic decks) and the steps of
    ``judged_steps`` against the reference (with `control`, the control in
    the program's place).  Returns (correct, {name: {value, limit}}, items
    judged, items failed)."""
    side = "control" if control else "program"
    readings = [r[side] for r in step_readings(
        sim, window.last, window.next_i, config, (side,))]
    failed = sum(not cmp.judge(r, limits)[0] for r in readings)
    if window.live_off is not None:
        print(f"check: the window's live particles against the inputs' "
              f"count: off by {window.live_off:.0f}", file=sys.stderr)
        off = {"particles_off": window.live_off}
        failed += not cmp.judge(off, {k: limits[k] for k in off})[0]
        readings.append(off)
    correct, checks = cmp.judge(cmp.worst(readings), limits)
    return correct, checks, len(readings), failed


def run_cell(cell: str, workload: dict, config: dict, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             bench: Optional[dict] = None,
             hook: Optional[Callable] = None,
             control: bool = False) -> dict:
    """One run of a cell on `device`; returns the result line's object.
    `hook(simulation)` may replace parts of the program before the run (the
    tests break the step with it); `control` judges the control (the
    reference in the precision below the deck's) instead of the program."""
    bench = bench if bench is not None else load_json(BENCHMARK)
    deck = deck_dict(config, workload)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sim = Sim(deck, config, workload, seed, dev, cell_chips(bench, cell))
    if hook is not None:
        hook(sim.sim)
    i = warm_up(sim)
    ctx = RunContext(cell=cell, workload=workload, deck=deck)
    ctx.setup_s = time.perf_counter() - t_start
    if trace:
        window = _traced_window(sim, seconds, i, dev, ctx)
    else:
        window = drive(sim, seconds, i)
    ctx.steps, ctx.wall_s, ctx.live_sum = (window.steps, window.wall_s,
                                           window.live_sum)
    if on_card:
        ctx.peak_bytes = sim.peak_bytes()
    metrics = read_metrics(cell_metrics(bench, cell, trace), ctx)
    t0 = time.perf_counter()
    correct, checks, judged, failed = check(
        sim, window, config, workload["limits"], control=control)
    window = None
    print(f"check: {judged} items judged in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    result = {
        "correct": correct, "attempted": judged, "failed": failed,
        "metrics": metrics, "device": device_info(dev, ctx, len(sim.devices))}
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_us / 1e6
        result["device"]["window_s"] = ctx.trace.wall_us / 1e6
        result["device"]["busy_s_by_card"] = [
            us / 1e6 for _, us in ctx.trace.busy_by_card]
        result["breakdown"] = breakdown(ctx.trace)
    result["checks"] = checks
    return result


def _traced_window(sim: Sim, seconds: float, i: int, dev,
                   ctx: RunContext) -> Window:
    """The window with the profiler on over the workload's traced steps
    (``trace``: ``skip`` steps into the window, ``steps`` long), and the
    same steps timed again untraced by the host clock: one deck later where
    the cell restarts its deck, else the steps right after.  The host side
    of the profiler stretches a launch-bound step; the device's busy time
    is the device's, so the idle share sets it against the untraced
    wall."""
    from torch.profiler import ProfilerActivity, profile

    spec = sim.workload["trace"]
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    first, n = spec["skip"], spec["steps"]
    again = first + (sim.total_steps if sim.workload["restart"] == "deck"
                     else n)
    wall = {}
    live_end = []

    def on_step(k):
        if k == first + n:
            sim.sync()
            wall["traced"] = time.perf_counter() - wall["traced"]
            prof.stop()
            live_end.extend(sim.live_counts())
        if k == again + n:
            sim.sync()
            wall["again"] = time.perf_counter() - wall["again"]
        if k == first:
            sim.sync()
            prof.start()
            wall["traced"] = time.perf_counter()
        if k == again:
            sim.sync()
            wall["again"] = time.perf_counter()

    window = drive(sim, seconds, i, on_step=on_step,
                   min_steps=max(first + n, again + n) + 1)
    ctx.trace = summarize(events_of(prof), n, wall["traced"] * 1e6,
                          cards=[d.index or 0 for d in sim.devices
                                 if d.type == "cuda"])
    ctx.timed_wall_us = wall["again"] * 1e6
    total_end = sum(live_end) or 1.0
    mean_live = window.live_sum / window.steps
    for sp, live in zip(sim.deck["species"], live_end):
        o = sp["shape_order"]
        ctx.traced_live[o] = (ctx.traced_live.get(o, 0.0)
                              + mean_live * live / total_end)
    s = ctx.trace
    print(f"trace: {n} steps traced at {s.wall_us / 1e3 / n:.3f} ms a step, "
          f"the same {n} untraced at {ctx.timed_wall_us / 1e3 / n:.3f}; "
          f"{len(s.ops)} device operations, {s.linked_share:.3f} linked to "
          f"their launch, {s.span_agreement:.3f} of those charged alike by "
          "the device-side range spans", file=sys.stderr)
    return window


def device_info(dev: torch.device, ctx: RunContext, count: int) -> dict:
    """The result's ``device``: `count` is the cards the run used,
    ``memory_peak_bytes`` the peak of the fullest."""
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": count, "memory_peak_bytes": int(ctx.peak_bytes or 0)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
