"""The port's command line (minipic_torch/cli.py) on the CPU: its artifacts,
the same snapshots and history as the JAX package's CLI, resume bit for bit
(across a window shift too), the multi-device simulations (--sharded and
--balanced, their resume, their checkpoint through the JAX package and
back), the writer choice, and the plot subcommand on a port run
folder."""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_tpu.cli import main as jax_cli  # noqa: E402
from minipic_torch import cli  # noqa: E402
from minipic_torch.decks.standard import CASES  # noqa: E402
from minipic_torch.io import hdf5 as th5  # noqa: E402
from minipic_torch.io import native  # noqa: E402
from minipic_torch.io.checkpoint import load_checkpoint  # noqa: E402

PULSE = ["--deck", "reference_pulse", "--nx", "48", "--ny", "48",
         "--steps", "50", "--save-every", "25", "--ranks", "4"]
TWO_STREAM = ["--deck", "two_stream", "--save-every", "50", "--precision",
              "f64", "--no-save", "--device", "cpu"]
WINDOW = ["--deck", "laser_wakefield_window", "--nx", "64", "--ny", "32",
          "--save-every", "50", "--precision", "f64", "--no-save",
          "--device", "cpu"]


def _run(args):
    assert cli.main(args) == 0


def _history(out):
    with open(os.path.join(out, "history.json")) as f:
        return json.load(f)


def _same_checkpoints(a, b):
    """Two checkpoints, every tensor bit for bit."""
    sa = load_checkpoint(os.path.join(a, "checkpoint.npz"), device="cpu")
    sb = load_checkpoint(os.path.join(b, "checkpoint.npz"), device="cpu")
    assert int(sa.step) == int(sb.step)
    for x, y in zip(sa.fields, sb.fields):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert len(sa.species) == len(sb.species)
    for pa, pb in zip(sa.species, sb.species):
        for name, x, y in zip(pa._fields, pa, pb):
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)
    np.testing.assert_array_equal(sa.drift.numpy(), sb.drift.numpy())
    return sa, sb


@pytest.fixture(scope="module")
def pulse_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pulse") / "Fields")
    _run(PULSE + ["--out", out, "--device", "cpu"])
    return out


@pytest.fixture(scope="module")
def two_stream_20(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ts") / "full")
    _run(TWO_STREAM + ["--steps", "20", "--out", out])
    return out


def test_cli_list(capsys):
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert len(lines) == len(CASES) == 9
    for name in CASES:
        assert name in lines


def test_cli_reference_pulse_artifacts(pulse_run):
    files = sorted(os.listdir(pulse_run))
    for name in ("params.txt", "history.json", "checkpoint.npz"):
        assert name in files
    assert sum(f.startswith("fields_rank_") for f in files) == 3 * 4
    assert th5.available_steps(pulse_run) == [0, 25, 50]
    fe = np.asarray(_history(pulse_run)["field_energy"])
    assert np.all(np.isfinite(fe)) and fe[0] > 0
    # Vacuum: the field energy is conserved to f32 round-off.
    assert abs(fe[-1] - fe[0]) / fe[0] < 1e-4


def test_cli_reference_pulse_f64_equals_jax_cli(tmp_path):
    """The same fields-only run through both CLIs in f64: the same files,
    snapshots equal to 1e-12, the recorded field energies to 1e-12."""
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli(PULSE + ["--precision", "f64", "--out", jout]) == 0
    _run(PULSE + ["--precision", "f64", "--out", tout, "--device", "cpu"])
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    kw = dict(nx_global=48, ny_global=48, guard=2, interior_nx=24,
              interior_ny=24)
    for step in (0, 25, 50):
        for q in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
            np.testing.assert_allclose(
                th5.load_field(step, tout, q, **kw),
                th5.load_field(step, jout, q, **kw), rtol=0, atol=1e-12,
                err_msg=f"{q} at step {step}")
    ht, hj = _history(tout), _history(jout)
    assert sorted(ht) == sorted(hj)
    assert ht["steps"] == hj["steps"] == list(range(1, 51))
    np.testing.assert_allclose(ht["field_energy"], hj["field_energy"],
                               rtol=1e-12)
    assert ht["overflow"] == hj["overflow"]
    assert ht["live_skew"] == hj["live_skew"]


def test_cli_two_stream_f64_equals_jax_cli(tmp_path):
    """two_stream (it asks for the int8 deposit) at 32^2 through both CLIs
    in f64 on the CPU: JAX's f64 run takes its exact deposit, and so does
    the port's (its f64 mode).  The same files; the snapshots' fields
    within 1e-11 of the largest component's peak (2e-13 measured) and
    the energies within 1e-9 relative: the seeders agree to 2 ulp
    (test_torch_decks.py), not bit for bit, and the port re-bins by
    rebin_auto where JAX sorts."""
    args = ["--deck", "two_stream", "--nx", "32", "--ny", "32", "--steps",
            "20", "--save-every", "10", "--precision", "f64"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli(args + ["--out", jout]) == 0
    _run(args + ["--out", tout, "--device", "cpu"])
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    kw = dict(nx_global=32, ny_global=32, guard=4, interior_nx=8,
              interior_ny=8)
    comps = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")
    for step in (10, 20):
        want = {q: th5.load_field(step, jout, q, **kw) for q in comps}
        # The beams drive Ex; the other components are round-off, held to
        # the same absolute bar.
        peak = max(np.abs(a).max() for a in want.values())
        for q in comps:
            d = np.abs(th5.load_field(step, tout, q, **kw) - want[q]).max()
            assert d <= 1e-11 * peak, f"{q} at step {step}: {d / peak}"
    ht, hj = _history(tout), _history(jout)
    assert ht["steps"] == hj["steps"] == list(range(1, 21))
    for key in ("field_energy", "kinetic_energy"):
        np.testing.assert_allclose(ht[key], hj[key], rtol=1e-9,
                                   err_msg=key)
    assert ht["overflow"] == hj["overflow"]


def test_cli_two_stream_energy(two_stream_20):
    hist = _history(two_stream_20)
    tot = [f + sum(k) for f, k in zip(hist["field_energy"],
                                      hist["kinetic_energy"])]
    assert len(tot) == 20 and len(hist["kinetic_energy"][0]) == 3
    assert abs(tot[-1] - tot[0]) / tot[0] < 1e-6
    assert all(o == 0 for o in hist["overflow"])


def test_cli_resume_bit_exact(two_stream_20, tmp_path):
    """A run stopped at step 10 and resumed with --resume lands bit for bit
    on the uninterrupted run (tests/test_decks_cli.py's resume, on the
    port)."""
    out = str(tmp_path / "split")
    _run(TWO_STREAM + ["--steps", "10", "--out", out])
    _run(TWO_STREAM + ["--steps", "20", "--out", out, "--resume"])
    a, _ = _same_checkpoints(two_stream_20, out)
    assert int(a.step) == 20
    assert _history(out)["steps"] == list(range(11, 21))


def test_cli_window_resume_across_a_shift(tmp_path):
    """laser_wakefield_window stopped at step 15 and resumed to 30 lands bit
    for bit on the 30 straight steps, across the window's first shift."""
    full, split = str(tmp_path / "full"), str(tmp_path / "split")
    _run(WINDOW + ["--steps", "30", "--out", full])
    _run(WINDOW + ["--steps", "15", "--out", split])
    w15 = load_checkpoint(os.path.join(split, "checkpoint.npz"),
                          device="cpu").window_x0
    _run(WINDOW + ["--steps", "30", "--out", split, "--resume"])
    a, b = _same_checkpoints(full, split)
    assert int(w15) == 0
    assert int(a.window_x0) == int(b.window_x0) > 0


def test_cli_grows_on_the_step_that_overflows_at_any_cadence(tmp_path,
                                                             monkeypatch):
    """The CLI reads the overflow of every step that re-binned and grows the
    buckets on that step, whatever --diag-every is (JAX's CLI acts only on
    its cadence, so its growth lags at --diag-every > 1: ROADMAP C).
    laser_plasma at 64^2 with full buckets (headroom 1.0) drops a particle
    on its first re-bin, step 2."""
    import dataclasses

    from minipic_torch.decks import standard
    from minipic_torch.simulation import Simulation

    real_case, real_grow = standard.CASES["laser_plasma"], \
        Simulation.ensure_capacity

    def case(**kw):
        c = real_case(nx=64, ny=64)
        return dataclasses.replace(c, deck=dataclasses.replace(
            c.deck, capacity_headroom=1.0))

    calls = []

    def grow(self, overflow=0):
        calls.append((int(self.state.step), overflow))
        return real_grow(self, overflow)

    monkeypatch.setitem(standard.CASES, "laser_plasma", case)
    monkeypatch.setattr(Simulation, "ensure_capacity", grow)
    args = ["--deck", "laser_plasma", "--steps", "6", "--no-save",
            "--device", "cpu"]
    runs = {}
    for every in (1, 5):
        calls.clear()
        out = str(tmp_path / f"every{every}")
        _run(args + ["--diag-every", str(every), "--out", out])
        runs[every] = (list(calls), out, _history(out))
    assert runs[1][0] == runs[5][0] == [(2, 1)]
    assert runs[5][2]["steps"] == [5, 6] and runs[1][2]["overflow"][1] == 1
    _same_checkpoints(runs[1][1], runs[5][1])
    ckpt = load_checkpoint(os.path.join(runs[5][1], "checkpoint.npz"),
                           device="cpu")
    assert [p.capacity for p in ckpt.species] == [1536, 1536]


def test_cli_sharded_stress_smoke(tmp_path):
    """--sharded on load_balance_stress cut to 64^2 (its 2 x 4 mesh, every
    shard on the CPU; tests/test_decks_cli.py:57): no overflow, the live
    count kept, and the per-shard skew recorded."""
    out = str(tmp_path / "lb")
    _run(["--deck", "load_balance_stress", "--nx", "64", "--ny", "64",
          "--steps", "4", "--save-every", "4", "--sharded", "--out", out,
          "--no-save", "--device", "cpu"])
    hist = _history(out)
    assert hist["overflow"] == [0] * 4
    assert len(hist["live_skew"]) == 4 and min(hist["live_skew"]) >= 1.0
    ckpt = load_checkpoint(os.path.join(out, "checkpoint.npz"),
                           device="cpu")
    assert int(ckpt.step) == 4
    assert sum(int(p.alive_count()) for p in ckpt.species) == 2 * 95 * 64 * 64


BALANCED_WINDOW = WINDOW + ["--balanced"]


def test_cli_balanced_window_resume_bit_exact(tmp_path):
    """--balanced on the window deck, stopped at step 15 and resumed: bit
    for bit the straight 30-step run, window origin included
    (tests/test_decks_cli.py:96-127)."""
    a, b = str(tmp_path / "full"), str(tmp_path / "split")
    _run(BALANCED_WINDOW + ["--steps", "30", "--out", a])
    _run(BALANCED_WINDOW + ["--steps", "15", "--out", b])
    _run(BALANCED_WINDOW + ["--steps", "30", "--out", b, "--resume"])
    sa, sb = _same_checkpoints(a, b)
    assert int(sa.step) == 30
    assert int(sa.window_x0) == int(sb.window_x0) > 0


def test_cli_sharded_checkpoint_through_jax_and_back(tmp_path):
    """A checkpoint of the port's --sharded run (shard-major buckets) loads
    into the JAX package's load_checkpoint as it is, JAX's save_checkpoint
    writes it again, and the port resumes from that file onto its mesh:
    bit for bit the straight run."""
    from minipic_tpu.io.checkpoint import load_checkpoint as jload
    from minipic_tpu.io.checkpoint import save_checkpoint as jsave

    args = WINDOW + ["--sharded"]
    a, b = str(tmp_path / "full"), str(tmp_path / "split")
    _run(args + ["--steps", "24", "--out", a])
    _run(args + ["--steps", "12", "--out", b])
    mine = load_checkpoint(os.path.join(b, "checkpoint.npz"), device="cpu")
    theirs = jload(os.path.join(b, "checkpoint.npz"))
    for x, y in zip(mine.fields, theirs.fields):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for pm, pj in zip(mine.species, theirs.species):
        for x, y in zip(pm, pj):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert int(theirs.window_x0) == int(mine.window_x0)
    via = str(tmp_path / "via_jax.npz")
    jsave(via, theirs)
    _run(args + ["--steps", "24", "--out", b, "--resume", via])
    _same_checkpoints(a, b)


@pytest.mark.parametrize("args", [
    ["--sharded", "--balanced", "--device", "cpu"],
    ["--deck", "load_balance_bunching", "--sharded"],
    ["--deck", "load_balance_bunching", "--balanced"],
])
def test_cli_refuses_what_it_cannot_run(tmp_path, monkeypatch, args):
    """Both layouts at once, or a multi-device simulation on the card (the
    default device) without one: refused before anything is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(args + ["--out", str(tmp_path)])
    msg = str(e.value.code)
    assert "mutually exclusive" in msg or "CUDA" in msg
    assert not os.listdir(tmp_path)


def test_cli_needs_the_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(PULSE + ["--out", str(tmp_path)])
    assert "CUDA" in str(e.value.code)


def test_cli_f64_on_the_card_resolves_to_the_kernels(tmp_path, monkeypatch):
    """--precision f64 on the card (here a monkeypatched one) builds the
    deck in f64 and its simulation on the card, whose step takes the
    kernels: the advance in its f64 mode for every species (the deck asks
    for int8), and the re-bin kernels on float64 channels."""
    from minipic_torch.decks.standard import Case
    from minipic_torch.simulation import deposit_modes, resolve_backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = {}

    class Built(Exception):
        pass

    def simulation(case, seed=0, device="cuda", **kw):
        seen.update(deck=case.deck, device=torch.device(device))
        raise Built

    monkeypatch.setattr(Case, "simulation", simulation)
    with pytest.raises(Built):
        cli.main(TWO_STREAM[:-2] + ["--out", str(tmp_path)])
    deck = seen["deck"]
    assert deck.precision == "f64" and deck.dtype == torch.float64
    assert deck.deposit == "int8" and len(deck.species) == 3
    assert seen["device"].type == "cuda"
    assert resolve_backend(seen["device"]) == "cuda"
    assert deposit_modes(deck) == ["f64"] * 3


def test_cli_without_a_writer_exits_non_zero(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert not th5.available()
    with pytest.raises(SystemExit) as e:
        cli.main(PULSE + ["--out", str(tmp_path / "o"), "--device", "cpu"])
    assert "no HDF5 writer" in str(e.value.code)
    assert not os.path.exists(tmp_path / "o")
    # --no-save needs no writer.
    _run(PULSE + ["--out", str(tmp_path / "n"), "--device", "cpu",
                  "--no-save"])


def test_cli_failed_snapshot_exits_non_zero(tmp_path, monkeypatch, capsys):
    """A snapshot file that fails to write makes the run exit 1 (JAX's CLI
    prints a warning and exits 0: ROADMAP C); the history and checkpoint
    are still written."""

    class Failing:
        def submit(self, fields, step):
            pass

        def flush(self):
            return 2

    monkeypatch.setattr(cli, "choose_writer",
                        lambda deck, args: (Failing(), "failing"))
    out = str(tmp_path / "o")
    assert cli.main(PULSE + ["--out", out, "--device", "cpu"]) == 1
    assert "2 snapshot files failed" in capsys.readouterr().err
    assert os.path.exists(os.path.join(out, "checkpoint.npz"))


def test_cli_prints_its_writer(tmp_path, capsys):
    _run(PULSE + ["--out", str(tmp_path), "--device", "cpu", "--steps", "2"])
    want = "native" if native.available() else "h5py"
    assert f"snapshot writer: {want}" in capsys.readouterr().out


def test_wipe_run_artifacts_leaves_other_files(tmp_path):
    for name in ("fields_rank_0_step_0.h5", "params.txt", "history.json",
                 "checkpoint.npz", "particles_rank_0_step_5.h5",
                 "notes.txt", "fields_backup.h5"):
        (tmp_path / name).write_text("x")
    assert cli.wipe_run_artifacts(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["fields_backup.h5", "notes.txt"]


def test_cli_save_particles_and_profile(tmp_path):
    """--save-particles writes a particle file per save; --profile writes a
    Chrome trace of the first steps and the step's spans and counters."""
    out = str(tmp_path / "o")
    _run(["--deck", "two_stream", "--nx", "32", "--ny", "32", "--steps", "4",
          "--save-every", "2", "--save-particles", "--device", "cpu",
          "--out", out, "--profile", str(tmp_path / "prof")])
    for s in (0, 2, 4):
        data = th5.load_particles(s, out)
        assert sorted(data) == ["ion", "left", "right"]
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with open(tmp_path / "prof" / "spans.json") as f:
        spans = json.load(f)
    names = {s["name"] for s in spans["spans"]}
    assert {"step", "minipic.fields"} <= names
    assert spans["steps"] == 4
    assert spans["counters"]["host_reads"] >= 4


ARTIFACTS = {"field": ("Bz_step_50.png",), "lineouts": ("line_slices_Bz.png",),
             "peaks": ("peak_amplitudes_Bz.png", "peak_amplitudes_Bz.csv"),
             "animation": ("Bz_animation",)}


@pytest.mark.parametrize("artifact", sorted(ARTIFACTS) + ["all"])
def test_cli_plot_from_a_port_run(pulse_run, tmp_path, artifact, capsys):
    pytest.importorskip("matplotlib")
    import shutil

    folder = str(tmp_path / "run")
    shutil.copytree(pulse_run, folder)
    assert cli.main(["plot", artifact, "--folder", folder,
                     "--max-frames", "3"]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    names = [n for k, v in ARTIFACTS.items() if artifact in (k, "all")
             for n in v]
    assert len(printed) == sum(not n.endswith(".csv") for n in names)
    for path in printed:
        assert os.path.getsize(path) > 0
    made = os.listdir(folder)
    for n in names:
        assert any(m.startswith(n) for m in made), n
