"""Command-line runner of the port (``minipic_tpu.cli``'s flags and
artifacts).

    python -m minipic_torch.cli --deck reference_pulse --out Simulation/Fields
    python -m minipic_torch.cli --deck two_stream --steps 500 --save-every 100
    python -m minipic_torch.cli --deck two_stream --device cpu --precision f64
    python -m minipic_torch.cli --deck load_balance_stress_counts --sharded
    python -m minipic_torch.cli plot all --folder Simulation/Fields

Runs on the card unless ``--device cpu`` is given.  ``--sharded`` runs the
block-sharded simulation and ``--balanced`` the striped one over the deck's
device mesh (``parallel/``: its mesh_shape, on the cards round-robin, or
every shard on the CPU with ``--device cpu``); a resumed run must use the
same layout and mesh as the run that saved.  Writes
reference-schema HDF5 snapshots (``fields_rank_<r>_step_<s>.h5``, readable
by the reference's File_reader.py) and, with ``--save-particles``,
``particles_rank_0_step_<s>.h5``; ``params.txt``; ``history.json`` of the
recorded steps' energies; ``window_offsets.json`` on a moving-window deck;
and a final ``checkpoint.npz`` that ``--resume`` continues bit for bit.
The ``plot`` subcommand renders the reference's four post-processing
artifacts from a run folder (``diag/plots.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time

# What a run writes into --out; nothing else there is ever removed.
ARTIFACT_PATTERNS = ("fields_rank_*.h5", "params.txt", "history.json",
                     "checkpoint.npz", "particles_rank_*.h5")
PROFILE_STEPS = 20


def wipe_run_artifacts(out: str) -> int:
    """Remove an earlier run's artifacts from `out` (snapshots, params,
    history, checkpoint).  The reference deletes and recreates its whole
    Simulation/Fields/ folder at start (Auxiliar_functions.cpp:275-295,
    PIC_2D.cpp:150-164); here only the known patterns go, so a mistyped
    --out never destroys other files.  Returns the number removed."""
    n = 0
    for pattern in ARTIFACT_PATTERNS:
        for path in glob.glob(os.path.join(out, pattern)):
            try:
                os.remove(path)
                n += 1
            except OSError:
                pass
    return n


def choose_writer(deck, args):
    """(writer, its name): the native writer where it builds, else h5py's;
    exits when saving is asked for and neither is there."""
    from .io import hdf5, native

    if args.no_save:
        return None, "none (--no-save)"
    if native.available():
        return (native.AsyncSnapshotWriter(deck.tiling, deck.guard, args.out,
                                           ranks=args.ranks), "native")
    if hdf5.available():
        return (hdf5.SnapshotWriter(deck.tiling, deck.guard, args.out,
                                    ranks=args.ranks), "h5py")
    raise SystemExit("minipic_torch: no HDF5 writer: the native writer does "
                     "not build (it needs g++ and a libhdf5 runtime) and "
                     "h5py is not installed; pass --no-save to run without "
                     "snapshots")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="minipic_torch", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--deck", default="reference_pulse",
                    help="named deck (decks/standard.py)")
    ap.add_argument("--out", default="Simulation/Fields", help="output folder")
    ap.add_argument("--steps", type=int, default=None,
                    help="last step (default: the deck's total_steps)")
    ap.add_argument("--save-every", type=int, default=None)
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--ny", type=int, default=None)
    ap.add_argument("--sharded", action="store_true",
                    help="block-sharded simulation over the device mesh")
    ap.add_argument("--balanced", action="store_true",
                    help="striped (load-balanced) simulation over the mesh")
    ap.add_argument("--ranks", type=int, default=1,
                    help="fan snapshot files over N virtual ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--diag-every", type=int, default=1,
        help="record energies every N steps (one device read a record); "
        "overflow is read on every step that re-binned whatever N is")
    ap.add_argument("--precision", choices=["f32", "f64"], default=None,
                    help="the deck's precision (f64: particles and fields in "
                    "double, the exact f64 deposit, on either device)")
    ap.add_argument(
        "--deposit", choices=["highest", "int8"], default=None,
        help="deposit mode: 'int8' = the matched-quantization integer "
        "deposit (exact continuity; needs uniform particle weights)")
    ap.add_argument("--list", action="store_true", help="list the decks")
    ap.add_argument("--no-save", action="store_true",
                    help="skip HDF5 snapshots")
    ap.add_argument(
        "--save-particles", action="store_true",
        help="also snapshot the live particles of each species on the save "
        "cadence (restart: io.checkpoint.particles_from_snapshot)")
    ap.add_argument(
        "--resume", nargs="?", const="auto", default=None, metavar="CKPT",
        help="resume from a checkpoint.npz (default: <out>/checkpoint.npz): "
        "fields, particles, step, drift and window origin, bit for bit, "
        "then continue to --steps / total_steps.  Implies --keep-existing.")
    ap.add_argument(
        "--keep-existing", action="store_true",
        help="do not remove an earlier run's artifacts from --out first")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (the kernels; the default) or cpu (their "
                    "plain versions)")
    ap.add_argument(
        "--profile", metavar="DIR", default=None,
        help=f"profile the first {PROFILE_STEPS} steps: a torch.profiler "
        "Chrome trace in DIR/trace.json, the step's spans (on the trace's "
        "clock) and host-read counters in DIR/spans.json, and one line a "
        "span name (calls and self host ms a step)")
    return ap


def _list_decks() -> None:
    from .decks.standard import CASES

    for name in sorted(CASES):
        print(name)


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "plot":
        from .diag.plots import cli_main as plot_main

        return plot_main(argv[1:])
    args = _parser().parse_args(argv)
    if args.list:
        _list_decks()
        return 0
    if args.sharded and args.balanced:
        raise SystemExit("minipic_torch: --sharded and --balanced are "
                         "mutually exclusive")

    import torch

    from . import trace
    from .decks.standard import make
    from .diag.history import RunHistory
    from .io.checkpoint import load_checkpoint, save_checkpoint
    from .io.params import write_params

    kw = {k: getattr(args, k) for k in ("nx", "ny") if getattr(args, k)}
    case = make(args.deck, **kw)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("minipic_torch: --device cuda (the default) but "
                         "CUDA is not available; --device cpu runs the "
                         "plain versions")
    deck = case.deck
    if args.precision:
        deck = dataclasses.replace(deck, precision=args.precision)
    if args.deposit:
        deck = dataclasses.replace(deck, deposit=args.deposit)
    writer, writer_name = choose_writer(deck, args)

    layout = ("sharded" if args.sharded else
              "balanced" if args.balanced else "single")
    sim = dataclasses.replace(case, deck=deck).simulation(
        seed=args.seed, device=args.device, layout=layout)
    start_step = 0
    if args.resume is not None:
        ckpt = (os.path.join(args.out, "checkpoint.npz")
                if args.resume == "auto" else args.resume)
        loaded = load_checkpoint(ckpt, deck, device=sim.device)
        if len(loaded.species) != len(deck.species):
            raise SystemExit(
                f"--resume: checkpoint has {len(loaded.species)} species, "
                f"deck has {len(deck.species)}")
        # A multi-device simulation splits the saved layout (shard-major or
        # striped storage order, window origin included) onto its mesh.
        sim.state = loaded
        start_step = int(loaded.step)
        print(f"resumed from {ckpt} at step {start_step}", flush=True)

    n_steps = args.steps if args.steps is not None else deck.total_steps
    save_every = (args.save_every if args.save_every is not None
                  else deck.save_frequency)
    os.makedirs(args.out, exist_ok=True)
    if not args.keep_existing and args.resume is None:
        wipe_run_artifacts(args.out)
    write_params(deck, args.out)
    hist = RunHistory()
    species_names = [s.name for s in deck.species]
    print(f"snapshot writer: {writer_name}", flush=True)

    window_log = {}
    ledger = os.path.join(args.out, "window_offsets.json")
    if args.resume is not None and os.path.exists(ledger):
        # Resume keeps the earlier snapshots in --out: their lab-frame
        # offsets stay in the rewritten ledger.
        with open(ledger) as f:
            window_log.update({int(k): int(v) for k, v in
                               json.load(f)["offsets_cells"].items()})

    saves, save_s = 0, 0.0

    def save(step):
        nonlocal saves, save_s
        if writer is None:
            return
        t0 = time.perf_counter()
        state = sim.state  # a multi-device simulation assembles it
        if state.window_x0 is not None:
            # Snapshots keep the window's coordinates; the ledger gives
            # lab x = window x + offset * dx.
            window_log[int(step)] = int(state.window_x0)
        writer.submit(state.fields, step)
        if args.save_particles and species_names:
            writer.submit_particles(state.species, species_names, step)
        saves += 1
        save_s += time.perf_counter() - t0

    if start_step == 0:
        save(0)
    mesh = getattr(sim, "mesh", None)
    where = (f"device={sim.device}" if mesh is None else
             f"{layout} mesh {mesh.shape[0]}x{mesh.shape[1]} on "
             f"{','.join(str(d) for d in mesh.distinct())}")
    print(f"deck={args.deck} grid={deck.ny}x{deck.nx} dt={deck.dt:.6g} "
          f"steps={n_steps} {where}", flush=True)
    prof, prof_until = None, min(start_step + PROFILE_STEPS, n_steps)
    if args.profile and prof_until > start_step:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if sim.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        trace.enable()

    def stop_profile(i):
        trace.disable()
        spans, counters = trace.drain()
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace (steps ..{i}) written to {path}", flush=True)
        steps = i - start_step
        with open(os.path.join(args.profile, "spans.json"), "w") as f:
            json.dump({"clock": "unix_ns", "steps": steps,
                       "spans": [dict(zip(("name", "parent", "start_ns",
                                           "end_ns"), s)) for s in spans],
                       "counters": counters}, f)
        for name, (calls, _, own) in trace.by_name(spans, steps).items():
            print(f"span {name}: {calls:.3f} calls a step, self "
                  f"{own:.4f} host ms a step", flush=True)
        for name, n in sorted(counters.items()):
            print(f"counter {name}: {n / steps:.3f} a step", flush=True)

    t_run = time.perf_counter()
    try:
        for i in range(start_step + 1, n_steps + 1):
            diag = sim.run_step(i)
            if prof is not None and i == prof_until:
                stop_profile(i)
                prof = None
            # History on the diag cadence, on save steps (the save print
            # reads the last record) and on the last step.
            if i % args.diag_every == 0 or i == n_steps or i % save_every == 0:
                hist.record(i, deck.dt, diag)
            if i % save_every == 0:
                save(i)
                sps = hist.steps_per_sec()
                print(
                    f"step {i}/{n_steps}  E_field={hist.field_energy[-1]:.4e}"
                    f"  E_total={hist.total_energy()[-1]:.6e}  "
                    f"drift={hist.energy_drift():.2e}  "
                    f"ovf={hist.overflow[-1]}  "
                    f"{sps and f'{sps:.1f} steps/s' or ''}", flush=True)
    finally:
        if prof is not None:
            stop_profile(n_steps)
    for d in ([sim.device] if mesh is None else mesh.distinct()):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    run_s = time.perf_counter() - t_run

    t0 = time.perf_counter()
    failed = writer.flush() if writer is not None else 0
    flush_s = time.perf_counter() - t0
    hist.save(os.path.join(args.out, "history.json"))
    if window_log:
        with open(ledger, "w") as f:
            json.dump({"cells_per_unit": 1.0 / deck.dx,
                       "offsets_cells": window_log}, f, indent=1)
    save_checkpoint(os.path.join(args.out, "checkpoint.npz"), sim.state)
    n_run = n_steps - start_step
    print(f"done: {n_run} steps in {run_s:.3f} s "
          f"({1e3 * run_s / max(n_run, 1):.4f} ms/step); {saves} saves, "
          f"{1e3 * save_s / max(saves, 1):.3f} ms a save, flush "
          f"{1e3 * flush_s:.3f} ms (writer {writer_name}); overflow "
          f"{sim.overflow_total}; energy drift {hist.energy_drift():.3e}; "
          f"outputs in {args.out}", flush=True)
    if failed:
        print(f"minipic_torch: {failed} snapshot files failed to write",
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
