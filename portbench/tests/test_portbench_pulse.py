"""The cell ``reference_pulse-f64``: its configuration equals the port's
deck, the pulse's init is the port's bit for bit, a deck without species
goes through the harness and is judged by its fields, and a broken step is
not correct.  The existing cells' inputs are the ones they always had."""
from __future__ import annotations

import dataclasses
import hashlib
import time
from types import SimpleNamespace as NS

import pytest
import torch

from portbench import cell, inputs, roofline
from portbench.metrics import fields_roofline

from conftest import load_balance_cell, pulse_cell, small_cell

SEED = 2 ** 31 + 5


def _fields_of(deck):
    return {f.name: getattr(deck, f.name) for f in dataclasses.fields(deck)
            if f.name != "species"}


def test_the_pulse_configuration_is_the_ports_deck():
    from minipic_torch.decks import standard

    want = standard.reference_pulse().deck
    workload, config = cell.cell_files("reference_pulse-f64")
    got = cell.build_deck(cell.deck_dict(config, workload))
    assert _fields_of(got) == _fields_of(dataclasses.replace(
        want, precision="f64"))
    assert got.species == () and workload["precision"] == "f64"
    assert got.total_steps == 63_639



@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_pulse_init_is_the_ports(dtype):
    from minipic_torch.decks import standard
    from minipic_torch.fields import init as finit

    deck = standard.reference_pulse().deck
    _, config = cell.cell_files("reference_pulse-f64")
    ours = inputs.init_fields(config["fields"], config["deck"], dtype, "cpu")
    port = finit.pulse_x(deck.domain, dtype=dtype, device="cpu")
    assert len(ours) == 6
    for a, b in zip(ours, port):
        assert a.dtype == dtype and torch.equal(a, b)
    assert float(ours[1].abs().max()) > 0.09


# sha256 (first 32 hex digits) of each existing cell's inputs at a small cut
# (every species channel, then the six fields), as the harness made them
# before the pulse and the window were added.
INPUT_DIGESTS = {
    "headline-int8": "9a086de6cf3bc5b0c56c0cfac95f191e",
    "headline-f64": "408b7c81ec5d0b419c24b3cdd1660482",
    "laser_plasma-f32": "fb222e971baec8f295d3b84a8713b531",
    "load_balance_stress_counts-striped": "e049e98e5b2371f8a149a95b7f9c3c16",
}


def _small(name):
    if name == "laser_plasma-f32":
        return small_cell(name, 64, steps=12)
    if name.startswith("load_balance"):
        return load_balance_cell("balanced")
    return small_cell(name, 32, ppc=16)


@pytest.mark.parametrize("name", sorted(INPUT_DIGESTS))
def test_the_existing_cells_inputs_are_unchanged(name):
    workload, config = _small(name)
    sim = cell.Sim(cell.deck_dict(config, workload), config, workload,
                   2 ** 31 + 21, "cpu")
    st = sim.make_initial(config)
    h = hashlib.sha256()
    for a in [a for p in st.species for a in p] + list(st.fields):
        h.update(a.contiguous().numpy().tobytes())
    assert h.hexdigest()[:32] == INPUT_DIGESTS[name]


def _pulse_run(hook=None, control=False):
    workload, config = pulse_cell()
    return cell.run_cell("reference_pulse-f64", workload, config, SEED, 0.3,
                         False, "cpu", time.perf_counter(), hook=hook,
                         control=control)


def test_a_fields_only_cut_is_judged_by_its_fields():
    """The 64^2 cut goes through the window and the check: nothing to
    pair, the live count 0 against the inputs' 0, the fields and the field
    energy equal the reference's; the control (the reference in float32
    in the program's place) is not correct by both."""
    res = _pulse_run()
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == 3  # last, start, the window's count
    values = {k: c["value"] for k, c in res["checks"].items()}
    for k in ("x_gap", "p_gap", "w_gap", "momentum_gap", "drift_gap",
              "particles_off"):
        assert values[k] == 0
    assert {"ms_per_step", "setup_s"} <= set(res["metrics"])
    ctl = _pulse_run(control=True)
    assert ctl["correct"] is False
    for k in ("field_gap", "energy_gap"):
        assert ctl["checks"][k]["value"] > 4 * ctl["checks"][k]["limit"]


def _bz_unchanged(sim):
    real = sim._step

    def step(state):
        new, diag = real(state)
        fields = new.fields._replace(bz=state.fields.bz)
        return new._replace(fields=fields), diag

    sim._step = step


def _in_f32(sim):
    """The whole step in float32, its result handed back as float64."""
    real = sim._step

    def step(state):
        low = state._replace(fields=type(state.fields)(
            *(f.float() for f in state.fields)))
        new, diag = real(low)
        return new._replace(fields=type(new.fields)(
            *(f.double() for f in new.fields))), diag

    sim._step = step


def _b_half_skipped(monkeypatch):
    """The second B half step of every step left out."""
    from minipic_torch import simulation

    real = simulation.update_b_half_periodic
    calls = []

    def b_half(f, *a, **kw):
        calls.append(1)
        return f if len(calls) % 2 == 0 else real(f, *a, **kw)

    monkeypatch.setattr(simulation, "update_b_half_periodic", b_half)


@pytest.mark.parametrize("fault", ["bz_unchanged", "b_half_skipped",
                                   "in_f32"])
def test_a_broken_fields_step_is_not_correct(fault, monkeypatch):
    hook = {"bz_unchanged": _bz_unchanged, "in_f32": _in_f32}.get(fault)
    if fault == "b_half_skipped":
        _b_half_skipped(monkeypatch)
    res = _pulse_run(hook=hook)
    assert res["correct"] is False
    assert res["failed"] >= 1
    assert res["checks"]["field_gap"]["value"] > 4 * res["checks"][
        "field_gap"]["limit"]


@pytest.mark.parametrize("kind", ["rebin", "capacity"])
def test_a_deck_without_species_refuses_to_wait_for_particles(kind):
    workload, config = pulse_cell()
    workload = dict(workload, judge=["last", kind, "start"])
    with pytest.raises(ValueError, match="no species"):
        cell.Sim(cell.deck_dict(config, workload), config, workload, 1,
                 "cpu")


def test_an_unknown_judge_kind_is_refused_at_load():
    workload, config = pulse_cell()
    with pytest.raises(ValueError, match="judge"):
        cell.Sim(cell.deck_dict(config, workload), config,
                 dict(workload, judge=["last", "first"]), 1, "cpu")


def test_the_fields_roofline_counts_the_grid_once():
    assert roofline.fields_bytes(450, 450, 8, False) == 12 * 450 ** 2 * 8
    assert roofline.fields_bytes(512, 512, 4, True) == 15 * 512 ** 2 * 4
    assert roofline.fields_least_s(450, 450, 8, False) == pytest.approx(
        5.803e-6, rel=1e-3)
    deck = {"nx": 450, "ny": 450, "precision": "f64", "species": []}
    trace = NS(steps=10, range_us=lambda name: {"minipic.fields": 580.3}[
        name])
    assert fields_roofline.read(NS(trace=trace, deck=deck)) == \
        pytest.approx(10.0, rel=1e-3)
    empty = NS(steps=10, range_us=lambda name: 0.0)
    assert fields_roofline.read(NS(trace=empty, deck=deck)) is None
    assert fields_roofline.read(NS(trace=None, deck=deck)) is None
