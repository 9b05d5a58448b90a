"""The harness: cells, configurations and metrics found by name from files;
the result line's keys; no card, no result; what a run imports."""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import cell, run

REPO = Path(__file__).resolve().parents[2]
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
                 "breakdown", "checks"}


def _bench():
    return cell.load_json(REPO / "BENCHMARK.json")


def test_every_cell_config_and_metric_is_found_by_name():
    bench = _bench()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        workload, config = cell.cell_files(w["name"])
        assert workload["config"] == w["config"]
        assert config["name"] == w["config"]
        assert (REPO / configs[w["config"]]["file"]).exists()
        assert config["reduced"] == configs[w["config"]]["reduced"]
        assert set(workload["limits"]) == set(cell.cmp.NUMBERS)
        cell.build_deck(cell.deck_dict(config, workload)).validate()
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = importlib.import_module(
            f"portbench.metrics.{m['name'].split('.')[0]}")
        assert callable(reader.read)


def test_each_cell_reports_its_metrics():
    bench = _bench()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in cell.cell_metrics(bench, w["name"], False)}
        per = cell.cell_metrics(bench, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert per and all(m["moves"] in e2e for m in per)


def test_result_line_has_only_the_contracts_keys(headline_small):
    workload, config = headline_small
    res = cell.run_cell("headline-int8", workload, config, 2 ** 31 + 77,
                        0.2, False, "cpu", time.perf_counter(),
                        bench=_bench())
    assert set(res) <= CONTRACT_KEYS
    assert list(res)[-1] == "checks"
    assert res["correct"] is True
    assert {"pushes_per_s", "setup_s"} <= set(res["metrics"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_traced_run_reads_the_per_layer_metrics_it_can(laser_small):
    workload, config = laser_small
    workload = dict(workload, trace={"skip": 2, "steps": 4})
    res = cell.run_cell("laser_plasma-f32", workload, config, 5, 0.1, True,
                        "cpu", time.perf_counter(), bench=_bench())
    assert set(res) <= CONTRACT_KEYS and res["correct"] is True
    # No device operation on the CPU: every device metric is left out.
    assert res["metrics"] == {}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_command_exits_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "headline-int8", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_the_command_exits_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and portbench/: no program to
    drive, no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    p = subprocess.run(
        [sys.executable, "-c",
         "import portbench.cell as c, sys; "
         "w, g = c.cell_files('headline-int8'); "
         "c.Sim(c.deck_dict(g, w), g, w, 1, 'cpu')"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(tmp_path)),
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "minipic_torch" in p.stderr


_IMPORTS = """
import json, sys, time, torch
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
from conftest import small_cell
from portbench import cell, run
w, c = small_cell("headline-int8", 32, ppc=4)
cell.run_cell("headline-int8", w, c, 3, 0.1, False, "cpu",
              time.perf_counter())
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = _IMPORTS.format(tests=str(Path(__file__).parent))
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=str(REPO)),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    mods = json.loads(p.stdout.strip().splitlines()[-1])
    assert run.forbidden_modules(mods) == []
    assert "minipic_torch" in {m.split(".")[0] for m in mods}


def test_the_reference_imports_nothing_of_the_program():
    code = ("import json, sys; import portbench.reference.step, "
            "portbench.reference.compare, portbench.inputs, "
            "portbench.roofline; "
            "print(json.dumps(sorted(sys.modules)))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=str(REPO)),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = {m.split(".")[0] for m in json.loads(p.stdout)}
    assert not tops & {"jax", "jaxlib", "flax", "minipic_tpu",
                       "minipic_torch"}


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules({"minipic_torch": 1, "jaxtyping": 1,
                                  "minipic_torch.ops": 1}) == []
    assert run.forbidden_modules({"jax.numpy": 1, "minipic_tpu": 1}) == [
        "jax", "minipic_tpu"]


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "laser_plasma-f32", "--seed", "12345", "--seconds", "2",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


def test_the_idle_share_is_taken_against_the_untraced_wall():
    """Busy time from the trace, wall time from the same steps untraced:
    the profiler's stretch of the traced steps does not count as idle."""
    from types import SimpleNamespace as NS

    from portbench.metrics import device_idle_pct

    trace = NS(ops=(1,), busy_us=1.5e3, wall_us=10e3)
    assert device_idle_pct.read(NS(trace=trace, timed_wall_us=6e3)) == \
        pytest.approx(75.0)
    assert device_idle_pct.read(NS(trace=NS(ops=(), busy_us=0.0, wall_us=1.0),
                                   timed_wall_us=1.0)) is None


def test_busy_time_is_each_cards_union_averaged_over_the_cards():
    """Two cards: each card's busy time is the union of its own
    operations, ``busy_us`` their mean, the idle gaps each card's averaged;
    the same operations read as one card's give today's single union."""
    from portbench.trace import Event, summarize

    host = [Event("portbench.step", 0.0, 100.0, False, 1, 1, 0),
            Event("aten::add", 5.0, 6.0, False, 1, 2, 0)]
    ops = [(10.0, 20.0, 0), (30.0, 40.0, 0), (15.0, 35.0, 1)]
    dev = [Event("k", a, b, True, 9, 10 + i, 2, card)
           for i, (a, b, card) in enumerate(ops)]
    two = summarize(host + dev, 1, 100.0, cards=[0, 1])
    assert two.busy_by_card == ((0, 20.0), (1, 20.0))
    assert two.busy_us == 20.0
    assert dict(two.idle_gaps) == {"portbench.step": 5.0}
    assert [o.card for o in two.ops] == [0, 0, 1]
    one = summarize(host + [e._replace(card=0) for e in dev], 1, 100.0,
                    cards=[0])
    assert one.busy_us == 30.0 and one.busy_by_card == ((0, 30.0),)
    assert one.idle_gaps == ()


@pytest.mark.parametrize("steps", [14, 10])
def test_the_window_sums_its_live_counts_in_folds(headline_small, steps,
                                                   monkeypatch):
    """The window keeps at most _LIVE_FOLD live counts on the device (past
    the fold its own memory no longer grows with its steps) and sums them
    all: a window of a multiple of the fold and one past it count every
    step."""
    monkeypatch.setattr(cell, "_LIVE_FOLD", 7)
    workload, config = headline_small
    sim = cell.Sim(cell.deck_dict(config, workload), config, workload, 3,
                   "cpu")
    win = cell.drive(sim, 0.0, 0, min_steps=steps)
    assert win.steps == steps
    assert win.live_sum == sim.n_inputs * steps
    assert win.live_off == 0
