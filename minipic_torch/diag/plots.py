"""Figures and animations from a run folder written by the CLI (the port's
own copy of ``minipic_tpu.diag.plots``), the user-facing half of the
reference's post-processor:

* ``plot_field``             <- File_reader.plot_field (:125-147)
* ``create_field_animation`` <- File_reader.create_field_animation (:153-204)
* ``plot_lineouts``          <- File_reader.plot_line_slices_along_x_steps (:210-283)
* ``plot_peak_amplitudes``   <- File_reader.track_peak_amplitudes_over_time (:290-381)

Each runs headless (the Agg backend, no ``plt.show``; matplotlib is
imported at first use), returns the path it wrote, and reads the run's
metadata from ``params.txt`` (``io.params.read_params``).  Axis units
follow the report (box in c/wp, t in 1/wp, fields in m_e c wp / e,
File_reader.py:140-142).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..io.hdf5 import available_steps, load_field
from ..io.params import read_params
from .analysis import peak_amplitudes


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _params(folder: str) -> Dict:
    return read_params(os.path.join(folder, "params.txt"))


def _load(folder: str, step: int, quantity: str, p: Dict) -> np.ndarray:
    return load_field(
        step,
        folder,
        quantity,
        nx_global=int(p["nx_global"]),
        ny_global=int(p["ny_global"]),
        guard=int(p["guard"]),
        interior_nx=int(p["interior_nx"]),
        interior_ny=int(p["interior_ny"]),
    )


def _field_label(quantity: str) -> str:
    return rf"{quantity} $[m_e c \omega_p / e]$"


def plot_field(
    folder: str,
    step: int,
    quantity: str = "Ex",
    out: Optional[str] = None,
) -> str:
    """Pseudocolor map of one component at one step (File_reader.py:125-147):
    pcolormesh on physical (x, y) edges, equal aspect, colorbar in field
    units, title carrying t = step*dt."""
    p = _params(folder)
    field = _load(folder, step, quantity, p)
    plt = _mpl()

    ny, nx = field.shape
    x_edges = np.linspace(0.0, float(p["box_x"]), nx + 1)
    y_edges = np.linspace(0.0, float(p["box_y"]), ny + 1)
    t = step * float(p["dt"])

    fig, ax = plt.subplots()
    mesh = ax.pcolormesh(x_edges, y_edges, field, shading="auto", cmap="viridis")
    cbar = fig.colorbar(mesh, ax=ax)
    cbar.set_label(_field_label(quantity))
    ax.set_xlabel(r"$x\,[c/\omega_p]$")
    ax.set_ylabel(r"$y\,[c/\omega_p]$")
    ax.set_title(rf"{quantity} at $t = {t:.3f}\,[\omega_p^{{-1}}]$")
    ax.set_aspect("equal", "box")
    fig.tight_layout()

    out = out or os.path.join(folder, f"{quantity}_step_{step}.png")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def create_field_animation(
    folder: str,
    quantity: str = "Ex",
    out: Optional[str] = None,
    fps: int = 20,
    max_frames: Optional[int] = None,
) -> str:
    """Animate one component over every saved step (File_reader.py:153-204).

    Writes mp4 via ffmpeg when available, else falls back to an animated
    gif via Pillow; the artifact extension follows the writer.  Color
    scale is fixed across frames (the reference's intent — its per-frame
    rescale lines are commented out).
    """
    import matplotlib.animation as animation

    p = _params(folder)
    steps = available_steps(folder)
    if not steps:
        raise FileNotFoundError(f"no snapshots in {folder}")
    if max_frames is not None and len(steps) > max_frames:
        stride = -(-len(steps) // max_frames)
        steps = steps[::stride]
    frames = [_load(folder, s, quantity, p) for s in steps]
    plt = _mpl()

    ny, nx = frames[0].shape
    x_edges = np.linspace(0.0, float(p["box_x"]), nx + 1)
    y_edges = np.linspace(0.0, float(p["box_y"]), ny + 1)
    vmax = max(float(np.abs(f).max()) for f in frames) or 1.0
    dt = float(p["dt"])

    fig, ax = plt.subplots()
    mesh = ax.pcolormesh(
        x_edges, y_edges, frames[0], shading="auto", cmap="viridis",
        vmin=-vmax, vmax=vmax,
    )
    fig.colorbar(mesh, ax=ax, label=_field_label(quantity))
    title = ax.set_title("")
    ax.set_xlabel(r"$x\,[c/\omega_p]$")
    ax.set_ylabel(r"$y\,[c/\omega_p]$")
    ax.set_aspect("equal", "box")

    def update(i):
        mesh.set_array(frames[i].ravel())
        title.set_text(rf"{quantity} at $t = {steps[i] * dt:.3f}\,[\omega_p^{{-1}}]$")
        return mesh, title

    ani = animation.FuncAnimation(
        fig, update, frames=len(frames), interval=1000 // fps, blit=False, repeat=False
    )
    if animation.FFMpegWriter.isAvailable():
        out = out or os.path.join(folder, f"{quantity}_animation.mp4")
        writer = animation.FFMpegWriter(fps=fps)
    else:
        out = out or os.path.join(folder, f"{quantity}_animation.gif")
        if out.endswith(".mp4"):
            out = out[:-4] + ".gif"
        writer = animation.PillowWriter(fps=fps)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    ani.save(out, writer=writer, dpi=100)
    plt.close(fig)
    return out


def plot_lineouts(
    folder: str,
    steps: Sequence[int],
    quantity: str = "Bz",
    y_index: Optional[int] = None,
    out: Optional[str] = None,
) -> str:
    """Overlaid horizontal lineouts at fixed y for several steps — the
    report's pulse-shape-preservation figure (File_reader.py:210-283,
    report Figs. 6-7)."""
    p = _params(folder)
    nx = int(p["nx_global"])
    if y_index is None:
        y_index = int(p["ny_global"]) // 2
    dt = float(p["dt"])
    x_vals = np.linspace(0.0, float(p["box_x"]), nx)
    plt = _mpl()

    fig, ax = plt.subplots(figsize=(10, 6))
    for s in steps:
        line = _load(folder, s, quantity, p)[y_index, :]
        ax.plot(x_vals, line, label=rf"Step {s} ($t = {s * dt:.1f}\,[\omega_p^{{-1}}]$)")
    y_phys = y_index * float(p["box_y"]) / int(p["ny_global"])
    ax.set_title(
        rf"{quantity} lineout along $x$ ($y = {y_phys:g}\,[c/\omega_p]$), nx = {nx}"
    )
    ax.set_xlabel(r"$x\,[c/\omega_p]$")
    ax.set_ylabel(_field_label(quantity))
    ax.set_xlim(0.0, float(p["box_x"]))
    ax.legend()
    fig.tight_layout()

    out = out or os.path.join(folder, f"line_slices_{quantity}.png")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def plot_peak_amplitudes(
    folder: str,
    quantity: str = "Bz",
    y_index: Optional[int] = None,
    out: Optional[str] = None,
    step_stride: int = 1,
    distance: int = 10,
) -> str:
    """Top-2 lineout peak amplitudes vs time — the reference's headline
    numerical-error diagnostic (File_reader.py:290-381, report Figs. 8-9).
    Returns the PNG path; the raw curves are also saved beside it, under
    the same name with ``.csv``, so the numbers are regenerable without
    re-reading every snapshot."""
    p = _params(folder)
    if y_index is None:
        y_index = int(p["ny_global"]) // 2
    dt = float(p["dt"])
    steps = available_steps(folder)[::step_stride]
    if not steps:
        raise FileNotFoundError(f"no snapshots in {folder}")

    times, p1, p2 = [], [], []
    for s in steps:
        line = _load(folder, s, quantity, p)[y_index, :]
        top = peak_amplitudes(line, distance=distance, top=2)
        times.append(s * dt)
        p1.append(top[0])
        p2.append(top[1])

    out = out or os.path.join(folder, f"peak_amplitudes_{quantity}.png")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    csv = os.path.splitext(out)[0] + ".csv"
    np.savetxt(
        csv,
        np.column_stack([steps, times, p1, p2]),
        header="step time peak1 peak2",
        comments="# ",
    )

    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.plot(times, p1, lw=2, label="1st peak amplitude")
    ax.plot(times, p2, lw=2, label="2nd peak amplitude")
    ax.set_title(rf"Peak amplitudes of ${quantity}$ vs time, nx = {int(p['nx_global'])}")
    ax.set_xlabel(r"$t\,[\omega_p^{-1}]$")
    ax.set_ylabel(_field_label(quantity))
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def cli_main(argv=None) -> int:
    """``python -m minipic_torch.cli plot <artifact> [--folder DIR] ...``:
    any of the four post-processing artifacts from a run folder (the
    reference's File_reader.py __main__ flow, :388-502)."""
    import argparse

    ap = argparse.ArgumentParser(prog="minipic_torch plot", description=cli_main.__doc__)
    ap.add_argument(
        "artifact",
        choices=["field", "animation", "lineouts", "peaks", "all"],
        help="which figure to produce",
    )
    ap.add_argument("--folder", default="Simulation/Fields", help="run output folder")
    ap.add_argument("--quantity", default="Bz", help="field component (Ex..Bz)")
    ap.add_argument("--step", type=int, default=None, help="step for 'field' (default: last)")
    ap.add_argument("--steps", type=int, nargs="*", default=None, help="steps for 'lineouts'")
    ap.add_argument("--y-index", type=int, default=None)
    ap.add_argument("--stride", type=int, default=1, help="step stride for 'peaks'")
    ap.add_argument("--fps", type=int, default=20)
    ap.add_argument("--max-frames", type=int, default=200, help="animation frame cap")
    ap.add_argument("--out", default=None, help="output artifact path")
    args = ap.parse_args(argv)

    steps = available_steps(args.folder)
    if not steps:
        print(f"no snapshots found in {args.folder}")
        return 1

    made = []
    if args.artifact in ("field", "all"):
        step = args.step if args.step is not None else steps[-1]
        made.append(plot_field(args.folder, step, args.quantity, out=args.out))
    if args.artifact in ("lineouts", "all"):
        sel = args.steps
        if not sel:  # default: 5 evenly spaced saved steps (reference picks by hand)
            idx = np.linspace(0, len(steps) - 1, min(5, len(steps))).astype(int)
            sel = [steps[i] for i in idx]
        made.append(
            plot_lineouts(args.folder, sel, args.quantity, y_index=args.y_index,
                          out=None if args.artifact == "all" else args.out)
        )
    if args.artifact in ("peaks", "all"):
        made.append(
            plot_peak_amplitudes(
                args.folder, args.quantity, y_index=args.y_index,
                out=None if args.artifact == "all" else args.out,
                step_stride=args.stride,
            )
        )
    if args.artifact in ("animation", "all"):
        made.append(
            create_field_animation(
                args.folder, args.quantity, fps=args.fps,
                out=None if args.artifact == "all" else args.out,
                max_frames=args.max_frames,
            )
        )
    for path in made:
        print(path)
    return 0
