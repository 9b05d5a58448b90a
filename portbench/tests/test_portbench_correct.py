"""What decides ``correct``: sound runs of the program pass, the control
(the reference in the precision below the deck's, in the program's place:
bfloat16 for float32, float32 for float64) fails, and so does a
run whose step is broken underneath, once for each fault a one-chip cell
can have.  At sizes the CPU holds; the card's runs are the benchmark's."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import cell, control
from portbench.reference import compare as cmp


def _run(name, small, hook=None, control_=False, seed=2 ** 31 + 5):
    workload, config = small
    return cell.run_cell(name, workload, config, seed, 0.3, False, "cpu",
                         time.perf_counter(), hook=hook, control=control_)


@pytest.mark.parametrize("name,fixture", [
    ("headline-int8", "headline_small"), ("laser_plasma-f32", "laser_small"),
    ("headline-f64", "headline_f64_small")])
def test_sound_runs_pass_and_the_control_fails(name, fixture, request):
    small = request.getfixturevalue(fixture)
    workload, config = small
    r = control.readings(name, 11, 0.2, "cpu", workload, config)
    limits = workload["limits"]
    assert len(r["program"]) == len(workload["judge"]) - (
        "capacity" in workload["judge"])  # no census in a 12-step deck
    for prog, ctl in zip(r["program"], r["control"]):
        assert cmp.judge(prog, limits)[0], prog
        assert not cmp.judge(ctl, limits)[0], ctl
    assert _run(name, small)["correct"] is True
    assert _run(name, small, control_=True)["correct"] is False


def _unchanged(sim):
    real = sim._step

    def step(state):
        _, diag = real(state)
        return state, diag

    sim._step = step


def _advance_fault(monkeypatch, alter):
    import minipic_torch.simulation as simulation

    real = simulation.advance_species_tiles

    def advance(p, ftiles, **kw):
        pnew, js, disp = real(p, ftiles, **kw)
        return alter(p, pnew, js, disp)

    monkeypatch.setattr(simulation, "advance_species_tiles", advance)


def _half_left_out(p, pnew, js, disp):
    """Odd tiles neither pushed nor deposited; the even tiles' current
    doubled in their place (the mean over the rest)."""
    odd = torch.arange(p.x.shape[0]) % 2 == 1
    chans = [torch.where(odd[:, None], a, b) for a, b in zip(p, pnew)]
    js = tuple(torch.where(odd[:, None, None], torch.zeros_like(j), 2 * j)
               for j in js)
    return type(pnew)(*chans), js, disp


def _one_momentum_altered(p, pnew, js, disp):
    px = pnew.px.clone()
    t, s = (pnew.w > 0).nonzero()[0]
    px[t, s] += 0.01
    return pnew._replace(px=px), js, disp


def _one_current_altered(p, pnew, js, disp):
    jz = js[2].clone()
    jz[3, 4, 4] += 1.0
    return pnew, (js[0], js[1], jz), disp


@pytest.mark.parametrize("fault", [
    "unchanged", "half_left_out", "momentum_altered", "current_altered"])
@pytest.mark.parametrize("name,fixture", [
    ("headline-int8", "headline_small"), ("laser_plasma-f32", "laser_small"),
    ("headline-f64", "headline_f64_small")])
def test_a_broken_step_is_not_correct(name, fixture, fault, request,
                                      monkeypatch):
    small = request.getfixturevalue(fixture)
    hook = None
    if fault == "unchanged":
        hook = _unchanged
    else:
        _advance_fault(monkeypatch, {
            "half_left_out": _half_left_out,
            "momentum_altered": _one_momentum_altered,
            "current_altered": _one_current_altered}[fault])
    res = _run(name, small, hook=hook)
    assert res["correct"] is False
    assert res["failed"] >= 1


def _relaid_every(k, alter=None, only=None):
    """A hook: after every `k`-th step (or step `only`), the first
    species' buckets grow by one bucket quantum, as the capacity policy
    grows them, and `alter` changes the grown buckets."""
    def hook(sim):
        from minipic_torch.parallel.balance import with_capacity
        from minipic_torch.simulation import align_capacity

        real = sim.run_step

        def run_step(i):
            diag = real(i)
            if (i == only) if only is not None else i % k == 0:
                sp = list(sim.state.species)
                grown = with_capacity(
                    sp[0], align_capacity(sim.deck, sp[0].capacity + 1))
                sp[0] = grown if alter is None else alter(grown)
                sim.state = sim.state._replace(species=tuple(sp))
                sim.capacity_changes += 1
            return diag

        sim.run_step = run_step
    return hook


def _one_dropped(p):
    w = p.w.clone()
    t, s = (w > 0).nonzero()[0]
    w[t, s] = 0.0
    return p._replace(w=w)


def _one_doubled(p):
    chans = [a.clone() for a in p]
    t, s = (p.w > 0).nonzero()[0]
    free = (p.w[t] == 0).nonzero()[0, 0]
    for a in chans:
        a[t, free] = a[t, s]
    return type(p)(*chans)


@pytest.mark.parametrize("alter,correct", [
    (None, True), (_one_dropped, False), (_one_doubled, False)])
def test_a_step_that_changes_the_buckets_is_judged(laser_small, alter,
                                                   correct):
    """The capacity step is held to the reference particle by particle: a
    sound growth passes, one that loses or doubles a particle does not."""
    res = _run("laser_plasma-f32", laser_small,
               hook=_relaid_every(3, alter))
    assert res["attempted"] == 4
    assert res["correct"] is correct


@pytest.mark.parametrize("alter", [_one_dropped, _one_doubled])
def test_the_window_counts_the_headlines_particles(headline_small, alter):
    """A particle lost or doubled in the warm-up's census shows in the
    window's live count.  Every step judged after a loss is sound, so the
    count alone fails; a double also leaves two particles on one partner."""
    res = _run("headline-int8", headline_small,
               hook=_relaid_every(0, alter, only=2))
    assert res["correct"] is False
    assert res["failed"] == 1 if alter is _one_dropped else res["failed"] >= 1
    assert res["checks"]["particles_off"]["value"] > 0


def test_a_restart_from_a_spoiled_state_is_not_correct(laser_small):
    """The program changes the kept initial state in place: the restarts
    start from it, and the judged start is held to the inputs made again
    from the seed."""
    def hook(sim):
        real = sim.run_step

        def run_step(i):
            if i == 1:
                sim.state.species[0].px.add_(0.05)
            return real(i)

        sim.run_step = run_step

    res = _run("laser_plasma-f32", laser_small, hook=hook)
    assert res["correct"] is False
