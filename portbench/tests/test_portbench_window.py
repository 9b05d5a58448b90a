"""The moving window in the reference (``reference/window.py``) against the
port's ``laser_wakefield_window`` deck, cut to 64 x 32 cells: the shift
predicate, the injection key and the injected plasma equal the port's, and
a run through the harness judges the step that shifts the window, particle
for particle.  A run whose window is broken underneath (the injection's key
off by one, the shift a step late, the leading columns left as they were)
is not correct."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import cell
from portbench.reference import window as rw

from conftest import window_cell

SEED = 2 ** 31 + 41


def _run():
    workload, config = window_cell()
    return cell.run_cell("laser_wakefield_window", workload, config, SEED,
                         0.2, False, "cpu", time.perf_counter())


def _deck_dict():
    workload, config = window_cell()
    return cell.deck_dict(config, workload)


def test_the_shift_predicate_and_key_are_the_ports():
    from minipic_torch.simulation import (window_injection_key,
                                          window_shift_now)

    deck = _deck_dict()
    pdeck = cell.build_deck(deck)
    w0, shifts = 0, 0
    for step in range(2000):
        for x0 in (w0 - 8, w0, w0 + 8):
            if x0 < 0:
                continue
            assert rw.shift_now(step, x0, deck) == bool(window_shift_now(
                step, x0, pdeck.dt, pdeck.tile_nx, pdeck.dx))
        if rw.shift_now(step, w0, deck):
            w0 += 8
            shifts += 1
    assert shifts > 80
    for i in range(2):
        for w0n in (8, 64, 4096):
            assert rw.injection_key(i, w0n) == window_injection_key(i, w0n)


def test_the_injected_column_is_the_ports():
    """The reference's injected particles are the live slots of the port's
    ``inject_column`` buckets, bit for bit, in f32 and f64."""
    from minipic_torch.particles.species import inject_column
    from minipic_torch.simulation import window_injection_key

    deck = _deck_dict()
    for dtype, precision in ((torch.float32, "f32"), (torch.float64, "f64")):
        pdeck = cell.build_deck(dict(deck, precision=precision))
        for i, (sp, spec) in enumerate(zip(deck["species"], pdeck.species)):
            w0n = 8 * 37
            port = inject_column(spec, pdeck.domain, pdeck.tiling, 384,
                                 window_injection_key(i, w0n), w0n, dtype,
                                 "cpu")
            ours = rw.inject(sp, i, deck, w0n, dtype, "cpu")
            live = port.w > 0
            rows = torch.arange(live.shape[0])[:, None].expand(live.shape)
            want_tile = rows[live] * pdeck.tiling.tile_cols + (
                pdeck.tiling.tile_cols - 1)
            assert torch.equal(ours.tile, want_tile)
            for a, b in zip(ours[1:], port):
                assert torch.equal(a, b[live])


def test_a_sound_window_run_is_judged_through_a_shift(monkeypatch):
    """The judged ``shift`` step does shift the port's window, and the run
    is correct, every particle paired."""
    from minipic_torch import simulation

    shifted = []
    real = simulation.shift_window

    def shift_window(deck, state, w0n):
        shifted.append(w0n)
        return real(deck, state, w0n)

    monkeypatch.setattr(simulation, "shift_window", shift_window)
    seen = []
    real_judged = cell.judged_steps

    def judged(sim, last, next_i, config):
        for rec in real_judged(sim, last, next_i, config):
            seen.append((sim.clock(rec.prev), sim.clock(rec.cur)))
            yield rec

    monkeypatch.setattr(cell, "judged_steps", judged)
    res = _run()
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == 3
    assert res["checks"]["particles_off"]["value"] == 0
    (_, w_before), (_, w_after) = seen[1]  # the judged shift
    assert w_after == w_before + 8 and w_after in shifted


def _late_shift(monkeypatch):
    from minipic_torch import simulation

    real = simulation.window_shift_now
    monkeypatch.setattr(simulation, "window_shift_now",
                        lambda step, w0, *a: real(step - 1, w0, *a))


def _key_off_by_one(monkeypatch):
    from minipic_torch import simulation

    real = simulation.window_injection_key
    monkeypatch.setattr(simulation, "window_injection_key",
                        lambda i, w0n: real(i, w0n) + 1)


def _leading_columns_kept(monkeypatch):
    """The shift rolls the fields, but the leading tile column keeps what
    it held before the shift instead of zeros."""
    from minipic_torch import simulation

    real = simulation.shift_window

    def shift_window(deck, state, w0n):
        new = real(deck, state, w0n)
        lead = torch.arange(deck.nx) >= deck.nx - deck.tile_nx
        fields = type(new.fields)(*(torch.where(lead, old, c) for old, c in
                                    zip(state.fields, new.fields)))
        return new._replace(fields=fields)

    monkeypatch.setattr(simulation, "shift_window", shift_window)


@pytest.mark.parametrize("fault", [_key_off_by_one, _late_shift,
                                   _leading_columns_kept],
                         ids=["key_off_by_one", "late_shift",
                              "leading_columns_kept"])
def test_a_broken_window_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert res["correct"] is False
    assert res["failed"] >= 1


def test_the_window_is_refused_where_it_cannot_be_judged():
    workload, config = window_cell()
    deck = cell.deck_dict(config, workload)
    with pytest.raises(ValueError, match="one device"):
        cell.check_cell(deck, dict(workload, layout="sharded"))
    deck = dict(deck, moving_window=False)
    with pytest.raises(ValueError, match="moving window"):
        cell.check_cell(deck, workload)


def test_the_window_control_is_not_correct():
    """The reference in bfloat16 in the program's place, its shifts and
    injections in bfloat16 too."""
    workload, config = window_cell()
    res = cell.run_cell("laser_wakefield_window", workload, config, SEED,
                        0.2, False, "cpu", time.perf_counter(), control=True)
    assert res["correct"] is False
