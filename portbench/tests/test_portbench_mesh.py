"""The mesh layouts: a deck run through the port's ``ShardedSimulation``
(block placement) or ``BalancedSimulation`` (striped placement), its shards
in the simulation's storage order, is judged by the same reference as a
one-device run.  Sound runs pass; a run with the storage order left out, or
with one shard's step broken, does not.  On the CPU every shard sits on the
CPU; the ``-m gpu`` test deals them round-robin over the cards present."""
from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import cell

from conftest import load_balance_cell

LAYOUTS = ("sharded", "balanced")


def _small(layout):
    workload, config = load_balance_cell(layout)
    workload["warmup"] = {"steps": 3, "force_rebin": 2}
    return workload, config


def _run(layout, hook=None, seed=2 ** 31 + 9):
    workload, config = _small(layout)
    return cell.run_cell("load_balance_stress_counts", workload, config, seed,
                         0.3, False, "cpu", time.perf_counter(), hook=hook)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_sound_mesh_run_is_correct(layout):
    res = _run(layout)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == 4  # last, rebin, start, the window's count
    assert res["device"]["count"] == 1


def test_the_mesh_holds_its_buckets_out_of_natural_order():
    """What the storage order test below leans on: neither layout keeps
    tile t in bucket row t."""
    for layout in LAYOUTS:
        workload, config = _small(layout)
        sim = cell.Sim(cell.deck_dict(config, workload), config, workload, 1,
                       "cpu")
        perm = sim.perm.tolist()
        assert sorted(perm) == list(range(len(perm)))
        assert perm != sorted(perm)


def _identity_order(monkeypatch):
    """The harness leaves the storage order out: the inputs go in, and the
    check reads the buckets, as if bucket row t held tile t."""
    real = cell.Sim.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.perm = torch.arange(self.perm.numel())

    monkeypatch.setattr(cell.Sim, "__init__", init)
    monkeypatch.setattr(cell.Sim, "to_storage", lambda self, st: st)


def _broken_shard(alter):
    """A hook: after every step, `alter(state, old)` changes the new
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


def _fields_unchanged(new, old, shard):
    fields = list(new.fields)
    fields[shard] = old.fields[shard]
    return new._replace(fields=fields)


def _tile_dropped(new, old, shard=2):
    species = list(new.species)
    p = species[shard][0]
    w = p.w.clone()
    w[(w > 0).sum(1).argmax()] = 0.0  # the shard's fullest tile
    species[shard] = (p._replace(w=w), *species[shard][1:])
    return new._replace(species=species)


@pytest.mark.parametrize("fault", [
    "storage_order", "momenta", "fields", "tile_dropped"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_broken_mesh_run_is_not_correct(layout, fault, monkeypatch):
    # Striped placement shares one field copy a device, the first shard's:
    # only that copy is read, so the stale one has to be that one.
    fields_shard = 0 if layout == "balanced" else 5
    hook = None
    if fault == "storage_order":
        _identity_order(monkeypatch)
    else:
        hook = _broken_shard({
            "momenta": _momenta_changed,
            "fields": lambda n, o: _fields_unchanged(n, o, fields_shard),
            "tile_dropped": _tile_dropped}[fault])
    res = _run(layout, hook=hook)
    assert res["correct"] is False
    assert res["failed"] >= 1


def test_the_single_layout_is_the_default(headline_small):
    """A workload without ``layout`` runs as one with "single".  Both
    windows are one step long (0 seconds), so both runs judge the same
    steps: a timed window may end on different steps in two runs, and the
    judged numbers follow the step."""
    workload, config = headline_small
    out = []
    for w in (workload, dict(workload, layout="single")):
        res = cell.run_cell("headline-int8", w, config, 2 ** 31 + 3, 0.0,
                            False, "cpu", time.perf_counter())
        out.append({k: v for k, v in res.items() if k != "metrics"})
    assert "layout" not in workload
    assert out[0] == out[1]
    assert out[0]["correct"] is True


def test_an_unknown_layout_is_refused(headline_small):
    workload, config = headline_small
    with pytest.raises(ValueError, match="layout"):
        cell.Sim(cell.deck_dict(config, workload), config,
                 dict(workload, layout="striped"), 1, "cpu")


def test_the_mesh_devices_go_round_robin_over_the_cards():
    workload, config = _small("sharded")
    deck = cell.build_deck(cell.deck_dict(config, workload))
    cards = cell.mesh_devices(deck, torch.device("cuda", 0), 4)
    assert [d.index for d in cards] == [0, 1, 2, 3, 0, 1, 2, 3]
    assert cell.mesh_devices(deck, torch.device("cpu"), 4) == [
        torch.device("cpu")] * 8


@pytest.mark.gpu
@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_mesh_cell_runs_correct_over_the_cards(layout, capsys, monkeypatch):
    """``load_balance_stress_counts`` at its full size (1024^2, ppc 95,
    2 x 4), its eight shards round-robin over every card present: the run
    is correct, reports every card and the peak of the fullest when the
    window closes.  Prints the untraced and the traced result lines."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chips = torch.cuda.device_count()
    name = "load_balance_stress_counts"
    workload, config = load_balance_cell(layout, nx=1024, ppc=95)
    bench = cell.load_json(cell.BENCHMARK)
    bench["workloads"].append({"name": name, "chips": chips})
    for m in bench["end_to_end"]:
        if m["name"] == "ms_per_step":
            m["workloads"].append(name)
    cards = []
    real = cell.Sim.peak_bytes

    def peak_bytes(self):
        cards[:] = [torch.cuda.max_memory_allocated(d) for d in self.devices]
        return real(self)

    monkeypatch.setattr(cell.Sim, "peak_bytes", peak_bytes)
    for trace in (False, True):
        # Each run's peak its own, though one process runs them all.
        for d in range(chips):
            torch.zeros(1, device=f"cuda:{d}")
            torch.cuda.reset_peak_memory_stats(d)
        res = cell.run_cell(name, workload, config, 2 ** 31 + 11, 10.0,
                            trace, torch.device("cuda", 0),
                            time.perf_counter(), bench=bench)
        with capsys.disabled():
            print(f"\n{layout} on {chips} cards, trace {int(trace)}, peak "
                  f"by card {cards}: " + json.dumps(res))
        assert res["correct"] is True, res["checks"]
        assert res["device"]["count"] == min(chips, 8)
        assert len(cards) == min(chips, 8)
        assert res["device"]["memory_peak_bytes"] == max(cards)
        if not trace:
            assert {"ms_per_step", "peak_mem_gb", "setup_s"} <= set(
                res["metrics"])
        else:
            busy = res["device"]["busy_s_by_card"]
            assert len(busy) == min(chips, 8) and min(busy) > 0
            assert res["device"]["busy_s"] == pytest.approx(
                sum(busy) / len(busy))
