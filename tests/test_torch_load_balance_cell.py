"""The benchmark's load-balance cell (``portbench``'s
``load_balance_stress_counts-striped``) on the CPU: its configuration is the
port's ``load_balance_stress_counts`` deck; a 32^2 cut of it through
``BalancedSimulation.run_step`` over 8 CPU shards is judged correct by the
plain reference, and not correct with one shard broken; with the recorder
on, the mesh step opens its spans, reads the device only through
``trace.read``, and counts every hand-off between devices."""
import copy
import dataclasses
import sys
import time

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

from minipic_torch import trace  # noqa: E402
from minipic_torch.decks import standard  # noqa: E402
from minipic_torch.parallel.balanced import BalancedSimulation  # noqa: E402
from minipic_torch.parallel.mesh import (PEER_BYTES,  # noqa: E402
                                         PEER_COPIES)
from portbench import cell  # noqa: E402

CELL = "load_balance_stress_counts-striped"
# What portbench/README.md asks of a workload file.
WORKLOAD_KEYS = {"config", "precision", "deposit", "entry", "restart",
                 "warmup", "trace", "judge", "limits"}
SEED = 2 ** 31 + 19


def test_the_configuration_is_the_ports_deck():
    workload, config = cell.cell_files(CELL)
    got = cell.build_deck(cell.deck_dict(config, workload))
    want = standard.load_balance_stress_counts().deck
    for f in dataclasses.fields(want):
        if f.name != "species":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert len(got.species) == len(want.species)
    x = torch.linspace(0, 102.4, 1001)[None, :]
    y = torch.linspace(0, 102.4, 9)[:, None]
    for a, b in zip(got.species, want.species):
        for f in dataclasses.fields(b):
            if f.name != "density":
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert torch.equal(a.density(x, y), b.density(x, y))


def test_the_workload_names_what_the_harness_reads():
    workload, config = cell.cell_files(CELL)
    assert WORKLOAD_KEYS <= set(workload)
    assert workload["layout"] == "balanced"
    assert workload["entry"] == "run_step"
    assert set(workload["limits"]) == set(cell.cmp.NUMBERS)
    bench = cell.load_json(cell.BENCHMARK)
    entry = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert entry["chips"] == 4 and entry["config"] == config["name"]
    conf = {c["name"]: c for c in bench["configs"]}[config["name"]]
    assert conf["reduced"] == config["reduced"]
    assert set(config["assumed"]) >= {"chips", "particles", "load_mode",
                                      "placement"}


def _cut(nx=32, ppc=16):
    """The cell on an nx^2 grid of the same cell size, tiles and guard,
    the blob scaled to the box, `ppc` particles a cell; a warm-up of three
    steps with a re-bin forced before the second."""
    workload, config = cell.cell_files(CELL)
    config = copy.deepcopy(config)
    deck = config["deck"]
    f = nx / deck["nx"]
    deck["box_x"] *= f
    deck["box_y"] *= f
    deck["nx"] = deck["ny"] = nx
    for sp in deck["species"]:
        sp["ppc"] = ppc
        for k in ("x0", "y0", "radius"):
            sp["density"][k] *= f
    workload = dict(copy.deepcopy(workload),
                    warmup={"steps": 3, "force_rebin": 2})
    return workload, config


def _run(monkeypatch, hook=None):
    # The judged re-bin is forced after two steps without one, not 100.
    monkeypatch.setattr(cell, "_REBIN_WAIT", 2)
    workload, config = _cut()
    return cell.run_cell(CELL, workload, config, SEED, 0.2, False, "cpu",
                         time.perf_counter(), hook=hook)


def _broken_shard(alter):
    """A hook: after every step, `alter(new, old)` changes the new
    per-shard state (`old` is the state the step started from)."""
    def hook(sim):
        real = sim._step

        def step(st):
            new, diag = real(st)
            return alter(new, st), diag

        sim._step = step
    return hook


def _momenta_changed(new, old, shard=5):
    species = list(new.species)
    p = species[shard][0]
    species[shard] = (p._replace(px=torch.where(p.w > 0, p.px + 0.01, p.px)),
                      *species[shard][1:])
    return new._replace(species=species)


def _fields_unchanged(new, old, shard=0):
    # Shards on one device share its field copy, the first shard's: that
    # is the one the step and the check read.
    fields = list(new.fields)
    fields[shard] = old.fields[shard]
    return new._replace(fields=fields)


def test_a_cut_of_the_cell_runs_correct_over_the_stripes(monkeypatch):
    res = _run(monkeypatch)
    assert res["correct"] is True, res["checks"]
    # last, rebin, start, the window's count
    assert res["attempted"] == 4 and res["failed"] == 0


@pytest.mark.parametrize("alter", [_momenta_changed, _fields_unchanged],
                         ids=["one_shards_momenta", "one_shards_fields"])
def test_a_broken_shard_is_not_correct(monkeypatch, alter):
    res = _run(monkeypatch, hook=_broken_shard(alter))
    assert res["correct"] is False
    assert res["failed"] >= 1


# Planted changes just inside the pairing's tolerances (``POS_TOL`` cells,
# ``REL_TOL`` of the largest momentum or weight), so every particle stays
# paired and only the particle gaps can see them.
POS, REL = cell.cmp.POS_TOL, cell.cmp.REL_TOL


def _judged_only(monkeypatch, alter):
    """A hook that applies `alter` to the steps the check judges only, so
    the window runs sound and the gap is the planted change itself."""
    judging = []
    real = cell.check

    def check(*a, **kw):
        judging.append(True)
        return real(*a, **kw)

    monkeypatch.setattr(cell, "check", check)
    return _broken_shard(lambda new, old: alter(new, old) if judging
                         else new)


def _live_electrons_of(channels, change, shard=5):
    def alter(new, old):
        species = list(new.species)
        p = species[shard][0]
        p = p._replace(**{c: torch.where(p.w > 0, change(getattr(p, c)),
                                         getattr(p, c)) for c in channels})
        species[shard] = (p, *species[shard][1:])
        return new._replace(species=species)
    return alter


@pytest.mark.parametrize("number,tol,alter", [
    ("x_gap", POS, _live_electrons_of(("x",), lambda a: a + 0.8 * POS)),
    ("p_gap", REL, _live_electrons_of(("px", "py", "pz"),
                                      lambda a: a * (1 + 0.8 * REL))),
    ("w_gap", REL, _live_electrons_of(("w",), lambda a: a * (1 + 0.8 * REL))),
], ids=["positions", "momenta", "weights"])
def test_a_change_that_stays_paired_reads_above_its_limit(monkeypatch,
                                                          number, tol, alter):
    """The particle gaps' upper reading: one shard's live electrons moved
    by less than the pairing tolerance read not correct by their gap, with
    every particle paired."""
    res = _run(monkeypatch, hook=_judged_only(monkeypatch, alter))
    checks = res["checks"]
    assert res["correct"] is False
    assert checks["particles_off"]["value"] == 0
    assert checks[number]["value"] >= 2 * checks[number]["limit"]
    assert checks[number]["value"] <= tol


def _deck():
    workload, config = _cut()
    return cell.build_deck(cell.deck_dict(config, workload))


def _conversions(monkeypatch):
    """Counts each device value turned into a host value by code of the
    mesh simulations (``minipic_torch/parallel/``) outside ``trace.read``."""
    seen = []

    def counted(name):
        real = getattr(torch.Tensor, name)

        def conv(self, *a, **kw):
            caller = sys._getframe(1).f_code.co_filename
            if "minipic_torch/parallel/" in caller.replace("\\", "/"):
                seen.append((name, caller, sys._getframe(1).f_lineno))
            return real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, conv)

    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "__index__"):
        counted(name)
    return seen


def _handed(monkeypatch):
    """The bytes of each ``Tensor.to`` that changes a tensor's device."""
    handed = []
    real = torch.Tensor.to

    def to(self, *a, **kw):
        dev = kw.get("device", a[0] if a else None)
        if isinstance(dev, (str, torch.device)) and \
                torch.device(dev) != self.device:
            handed.append(self.nbytes)
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", to)
    return handed


@pytest.mark.parametrize("devices", ["one", "two"])
def test_the_mesh_step_spans_reads_and_counts_its_hand_offs(monkeypatch,
                                                            devices):
    """A re-bin step (49) and a census step (50) of ``run_step`` with the
    recorder on.  On the CPU every tensor reports the device ``cpu``: with
    every shard on ``cpu`` no tensor changes device; over ``cpu:0`` and
    ``cpu:1`` every move is a ``Tensor.to``, as between two cards."""
    devs = ([torch.device("cpu")] * 8 if devices == "one"
            else [torch.device("cpu", s % 2) for s in range(8)])
    sim = BalancedSimulation(_deck(), seed=3, devices=devs)
    sim.run_step(1)  # first calls outside the record
    st = sim.shard_state
    sim.shard_state = st._replace(drift=torch.full_like(st.drift,
                                                        float("inf")))
    trace.drain()
    seen = _conversions(monkeypatch)
    handed = _handed(monkeypatch)
    trace.enable()
    try:
        diags = [sim.run_step(i) for i in (49, 50)]
    finally:
        trace.disable()
    monkeypatch.undo()
    spans, counters = trace.drain()
    assert diags[0].rebinned
    top = [s[0] for s in spans if s[1] == -1]
    assert top == ["step", "step"]
    names = {s[0] for s in spans}
    assert {"step.census", "step.read", "minipic.parallel", "minipic.fields",
            "minipic.advance", "minipic.rebin", "minipic.diag"} <= names
    # The drift each step, the overflow of the re-bin step, the census's
    # total and fullest tile of each species at step 50.
    reads = {"host_reads.drift": 2, "host_reads.overflow": 1,
             "host_reads.census": 2 * len(sim.deck.species)}
    assert {k: v for k, v in counters.items()
            if k.startswith("host_reads.")} == reads
    assert counters["host_reads"] == sum(reads.values())
    assert seen == []
    assert counters.get(PEER_COPIES, 0) == len(handed)
    assert counters.get(PEER_BYTES, 0) == sum(handed)
    assert (len(handed) > 0) == (devices == "two")
