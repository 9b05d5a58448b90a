"""Checkpoints for an exact restart (the port's own copy of
``minipic_tpu.io.checkpoint``).

* ``save_checkpoint`` / ``load_checkpoint``: one ``.npz`` of every state
  tensor (fields, each species' buckets, the step counter, the drift and
  the window's origin) under the JAX package's keys (``fields_<c>``,
  ``sp<i>_<c>``, ``step``, ``n_species``, ``drift``, ``window_x0``), so
  each package loads the other's file.  Bit for bit, f64 runs included.
* ``particles_from_snapshot`` / ``fields_from_snapshot``: a restart from
  the HDF5 snapshots (``io/hdf5.py``) alone.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.config import Deck
from ..core.state import FieldState, ParticleState, SimState


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, state: SimState) -> None:
    arrays = {f"fields_{n}": _np(getattr(state.fields, n))
              for n in FieldState._fields}
    for i, sp in enumerate(state.species):
        for n in ParticleState._fields:
            arrays[f"sp{i}_{n}"] = _np(getattr(sp, n))
    arrays["step"] = _np(state.step)
    arrays["n_species"] = np.asarray(len(state.species))
    if state.drift is not None:
        arrays["drift"] = _np(state.drift)
    if state.window_x0 is not None:
        arrays["window_x0"] = _np(state.window_x0)
    np.savez(path, **arrays)


def load_checkpoint(path: str, deck: Deck = None, device="cuda") -> SimState:
    """The checkpoint's state on `device`, each array's dtype kept.  A
    checkpoint without a drift (an older file) restarts between the drift
    and force thresholds when `deck` uses the drift trigger, so that the
    first step re-bins without force (a tile whose movers overflow may
    defer instead of dropping); without a deck it forces a re-bin."""
    device = torch.device(device)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(device)

    with np.load(path) as z:
        fields = FieldState(*(t(z[f"fields_{n}"])
                              for n in FieldState._fields))
        species = tuple(
            ParticleState(*(t(z[f"sp{i}_{n}"])
                            for n in ParticleState._fields))
            for i in range(int(z["n_species"])))
        step = t(z["step"])
        if "drift" in z:
            drift = t(z["drift"])
        elif deck is not None and deck.species and deck.uses_drift_trigger():
            drift = torch.tensor(deck.drift_threshold() + 1e-3,
                                 dtype=torch.float32, device=device)
        else:
            drift = torch.tensor(1e9, dtype=torch.float32, device=device)
        w0 = t(z["window_x0"]) if "window_x0" in z else None
    if w0 is None and deck is not None and deck.moving_window:
        w0 = torch.zeros((), dtype=torch.int32, device=device)
    return SimState(fields=fields, species=species, step=step, drift=drift,
                    window_x0=w0)


def particles_from_snapshot(step: int, folder: str, deck: Deck,
                            device="cuda") -> Tuple[ParticleState, ...]:
    """Tile buckets rebuilt from a particle snapshot (``io.hdf5.
    save_particles`` or the native writer's ``submit_particles``): each
    species' live particles padded into a flat slot pool and re-binned
    (``binning.rebin_flat``) into the deck's buckets.  The capacity is the
    deck's, grown to the densest tile, in the port's bucket quantum
    (``simulation.align_capacity``: kchunk, or 512 slots for whole-bucket
    chunks; the JAX package rounds to 128 there), so the restart loses
    nothing."""
    from ..particles.binning import rebin_flat
    from ..simulation import align_capacity
    from .hdf5 import PARTICLE_CHANNELS, load_particles

    device = torch.device(device)
    data = load_particles(step, folder)
    tiling = deck.tiling
    out = []
    for spec in deck.species:
        d = data[spec.name]
        n = len(d["x"])
        col = np.floor(d["x"] / tiling.tile_nx).astype(np.int64)
        row = np.floor(d["y"] / tiling.tile_ny).astype(np.int64)
        tid = row * tiling.tile_cols + col
        dens = (int(np.bincount(tid, minlength=tiling.num_tiles).max())
                if n else 0)
        cap = align_capacity(deck, max(deck.capacity(), dens))
        pool = tiling.num_tiles * cap
        flat = ParticleState(*(
            torch.tensor(np.pad(d[k].astype(np.float64), (0, pool - n)),
                         dtype=deck.dtype, device=device)
            for k in PARTICLE_CHANNELS))
        p, ovf = rebin_flat(flat, tile_rows=tiling.tile_rows,
                            tile_cols=tiling.tile_cols,
                            tile_nx=tiling.tile_nx, tile_ny=tiling.tile_ny,
                            capacity=cap)
        if int(ovf) != 0:
            raise ValueError(f"particle restart overflow for species "
                             f"{spec.name}")
        out.append(p)
    return tuple(out)


def fields_from_snapshot(step: int, folder: str, deck: Deck,
                         device="cuda") -> FieldState:
    """A FieldState rebuilt from a reference-schema HDF5 snapshot (the
    reference itself has no load path)."""
    from .hdf5 import load_field

    kw = dict(nx_global=deck.nx, ny_global=deck.ny, guard=deck.guard,
              interior_nx=deck.tile_nx, interior_ny=deck.tile_ny)
    return FieldState(*(
        torch.tensor(load_field(step, folder, q, **kw), dtype=deck.dtype,
                     device=device)
        for q in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")))
