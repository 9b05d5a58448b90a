"""The moving window of the port's step, over the reference's flat
particles: a frozen copy of ``window_shift_now``, ``shift_window`` and
``window_injection_key`` (``minipic_torch/simulation.py``) and of the
injected plasma (``inject_column`` and ``mix_seed`` of
``minipic_torch/particles/species.py``).  Imports nothing of the program.

* When: the light front at t = (step + 1) dt has crossed the next tile
  column past the window_x0 // tile_nx shifts taken, in float32 numpy,
  anchored on window_x0 (a shift that rounding delays comes a step later).
* The fields roll tile_nx columns left; the leading tile_nx columns are
  zeroed.
* Each species' particles move one tile column left, x -= tile_nx; those
  of the trailing tile column flow out.
* The leading tile column takes fresh plasma on the lattice, the density
  at absolute x (x + the new window_x0): for species i at origin w0n each
  tile row r draws its momenta's unit normals, [3, ppc * tile cells], in
  the deck's type from a CPU generator seeded with
  mix_seed(mix_seed(0x77, i, w0n), r).
"""
from __future__ import annotations

import hashlib
import math
from typing import Tuple

import numpy as np
import torch

from .. import inputs
from .step import Flat, Geometry, home_tile


def program_dt(deck: dict) -> float:
    """The step's dt as the port's deck works it out (dt_factor times the
    Courant limit)."""
    dx, dy = deck["box_x"] / deck["nx"], deck["box_y"] / deck["ny"]
    return deck["dt_factor"] * (1.0 / math.sqrt(1.0 / dx ** 2
                                                 + 1.0 / dy ** 2))


def shift_now(step: int, window_x0: int, deck: dict) -> bool:
    """Whether the step from a state at `step` with origin `window_x0`
    (cells) shifts the window."""
    tile_nx = deck["tile_nx"]
    period = np.float32(tile_nx * (deck["box_x"] / deck["nx"]))
    done = (np.asarray(window_x0) // tile_nx).astype(np.float32)
    t1 = ((np.asarray(step).astype(np.float32) + np.float32(1.0))
          * np.float32(program_dt(deck)))
    return bool(t1 >= (done + np.float32(1.0)) * period)


def mix_seed(*parts: int) -> int:
    """A 63-bit seed from every integer of `parts` (blake2b of their
    decimal forms)."""
    text = ":".join(str(int(v)) for v in parts).encode()
    digest = hashlib.blake2b(text, digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def injection_key(species_index: int, w0n: int) -> int:
    return mix_seed(0x77, species_index, w0n)


def inject(sp: dict, index: int, deck: dict, w0n: int, dtype,
           device) -> Flat:
    """The live particles of species entry `sp` (the deck's `index`-th)
    that the shift to origin `w0n` puts in the leading tile column, in the
    window's frame, each with the tile it sits in."""
    cols = deck["nx"] // deck["tile_nx"]
    rows = deck["ny"] // deck["tile_ny"]
    per_tile = sp["ppc"] * deck["tile_nx"] * deck["tile_ny"]
    key = injection_key(index, w0n)
    noise = None
    if any(u > 0 for u in inputs.thermal_spread(sp)):
        gen = torch.Generator()
        draws = []
        for r in range(rows):
            gen.manual_seed(mix_seed(key, r))
            draws.append(torch.randn((3, per_tile), generator=gen,
                                     dtype=dtype))
        noise = torch.stack(draws, dim=1).to(device)
    trow = torch.tensor(list(range(rows)), dtype=dtype)[:, None].to(device)
    tcol = torch.full((rows, 1), float(cols - 1), dtype=dtype, device=device)
    chans = inputs.lattice_buckets(sp, deck, trow, tcol, float(w0n), dtype,
                                   device, lambda axis, shape: noise[axis])
    tile = (torch.arange(rows, device=device) * cols + (cols - 1))[:, None]
    live = chans[5] > 0
    return Flat(tile.expand(live.shape)[live], *(a[live] for a in chans))


def shift(species: Tuple[Flat, ...], fields, deck: dict, geo: Geometry,
          w0n: int, dtype) -> Tuple[Tuple[Flat, ...], tuple]:
    """One shift to origin `w0n` of particles that sit in the tiles of
    their positions (the shift's step re-bins) and of the fields."""
    s = geo.tile_nx
    keep = torch.arange(geo.nx, device=fields[0].device) < geo.nx - s
    fields = tuple(torch.where(keep, torch.roll(c, -s, dims=1),
                               torch.zeros_like(c)) for c in fields)
    out = []
    for i, (sp, p) in enumerate(zip(deck["species"], species)):
        tile = home_tile(p.x, p.y, geo)
        stay = tile % geo.tile_cols > 0
        moved = Flat(tile[stay] - 1, p.x[stay] - s,
                     *(a[stay] for a in p[2:]))
        fresh = inject(sp, i, deck, w0n, dtype, p.x.device)
        out.append(Flat(*(torch.cat([a, b]) for a, b in zip(moved, fresh))))
    return tuple(out), fields

