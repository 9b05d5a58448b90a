"""Species loading: quiet-start lattice positions, profile weights, thermal
momenta — the torch form of ``minipic_tpu.particles.species``.

* Positions: ppc macroparticles per cell on the lattice
  (i + (m+1/2)/ppc_x, j + (n+1/2)/ppc_y).
* Weights: w = n dxdy / ppc, or (load_mode="count") a uniform weight with
  per-cell live counts thinned to the profile, buckets live-compacted.
  The density sees absolute x (window frame plus the window's offset), so
  the moving window's injected column carries the plasma a static run
  would have loaded there.
* Momenta: drift + per-axis Gaussian spread.  ``load_species`` draws from
  the caller's ``torch.Generator``; ``inject_column`` from a CPU generator
  seeded per global tile row from its key, so the same key gives the same
  plasma on every device and in any decomposition of the rows.  The JAX
  package's random stream cannot be reproduced: loads agree with it in
  distribution, not bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core.config import SpeciesSpec
from ..core.geometry import Domain, Tiling
from ..core.state import ParticleState


def _lattice_factors(ppc: int) -> Tuple[int, int]:
    a = int(math.isqrt(ppc))
    while ppc % a != 0:
        a -= 1
    return a, ppc // a  # (per-x, per-y)


def mix_seed(*parts: int) -> int:
    """A 63-bit seed that depends on every integer of `parts` (blake2b of
    their decimal forms): the same parts give the same seed on any
    machine."""
    text = ":".join(str(int(v)) for v in parts).encode()
    digest = hashlib.blake2b(text, digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _load_buckets(spec: SpeciesSpec, domain: Domain, tiling: Tiling,
                  capacity: int, trow: torch.Tensor, tcol: torch.Tensor,
                  x_abs_offset: float, dtype: torch.dtype,
                  device: torch.device, draw: Callable) -> ParticleState:
    """Quiet-start lattice buckets [B, capacity] for the tiles at (trow,
    tcol) ([B, 1] each, window-frame tile coordinates).  The density sees
    x + x_abs_offset.  ``draw(axis, shape)`` gives the unit normals of
    momentum axis 0, 1 or 2; it is called only for an axis with a thermal
    spread, in axis order."""
    ppc_x, ppc_y = _lattice_factors(spec.ppc)
    nxt, nyt = tiling.tile_nx, tiling.tile_ny
    per_tile = spec.ppc * nxt * nyt
    if per_tile > capacity:
        raise ValueError(f"capacity {capacity} < ppc*tile cells = {per_tile}")
    nb = trow.shape[0]

    slots = torch.arange(per_tile, device=device)
    l = slots % ppc_x
    m = (slots // ppc_x) % ppc_y
    cell = slots // (ppc_x * ppc_y)
    xi = (cell % nxt).to(dtype) + (l.to(dtype) + 0.5) / ppc_x
    eta = (cell // nxt).to(dtype) + (m.to(dtype) + 0.5) / ppc_y
    x = tcol * nxt + xi[None, :]
    y = trow * nyt + eta[None, :]

    count_mode = spec.load_mode == "count" and spec.density is not None
    if spec.density is None:
        n = torch.ones_like(x)
    else:
        x_abs = x + x_abs_offset
        n = torch.as_tensor(spec.density(x_abs * domain.dx, y * domain.dy),
                            dtype=dtype, device=device)
    if count_mode:
        n_max = (torch.tensor(spec.n_max, dtype=dtype, device=device)
                 if spec.n_max is not None else n.max())
        sub_rank = ((m * ppc_x + l).to(dtype) + 0.5) / spec.ppc
        keep = sub_rank[None, :] < (n / torch.clamp(n_max, min=1e-30))
        w = torch.where(keep, n_max * (domain.dx * domain.dy / spec.ppc),
                        torch.zeros_like(n))
    else:
        w = n * (domain.dx * domain.dy / spec.ppc)

    shape = (nb, per_tile)
    moms = []
    for axis, (uth, drift) in enumerate(zip(
            spec.thermal_spread(), (spec.ux, spec.uy, spec.uz))):
        if uth <= 0:
            moms.append(torch.full(shape, drift, dtype=dtype, device=device))
        else:
            moms.append(draw(axis, shape) * uth + drift)
    chans = [x, y, *moms, w]
    if count_mode:
        # Live-compact each bucket (stable: live slots first, load order
        # kept) so the advance's live-count bound holds from step 0.
        order = torch.sort((w <= 0).to(torch.int8), dim=1, stable=True).indices
        chans = [torch.gather(a, 1, order) for a in chans]
    pad = capacity - per_tile
    return ParticleState(*(torch.nn.functional.pad(a.to(dtype), (0, pad))
                           for a in chans))


def load_species(spec: SpeciesSpec, domain: Domain, tiling: Tiling,
                 capacity: int, generator: torch.Generator,
                 dtype: torch.dtype, device: torch.device) -> ParticleState:
    """Tile-bucketed ParticleState [num_tiles, capacity] for one species;
    `generator` must live on `device`."""
    t = torch.arange(tiling.num_tiles, device=device)
    tcol = (t % tiling.tile_cols).to(dtype)[:, None]
    trow = (t // tiling.tile_cols).to(dtype)[:, None]

    def draw(axis, shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    return _load_buckets(spec, domain, tiling, capacity, trow, tcol, 0.0,
                         dtype, device, draw)


def counter_streaming_pair(spec: SpeciesSpec, drift: float, domain: Domain,
                           tiling: Tiling, capacity: int,
                           generator: torch.Generator, dtype: torch.dtype,
                           device: torch.device):
    """Two half-density beams of `spec` at +-drift along x (the two-stream
    fixture), both drawn from `generator`."""
    a = load_species(dataclasses.replace(spec, ux=drift), domain, tiling,
                     capacity, generator, dtype, device)
    b = load_species(dataclasses.replace(spec, ux=-drift), domain, tiling,
                     capacity, generator, dtype, device)
    return a._replace(w=a.w * 0.5), b._replace(w=b.w * 0.5)


def inject_column(spec: SpeciesSpec, domain: Domain, tiling: Tiling,
                  capacity: int, key: int, x0_cells: int,
                  dtype: torch.dtype, device: torch.device,
                  row_ids: Optional[Sequence[int]] = None) -> ParticleState:
    """Fresh plasma for the moving window's leading tile column: buckets
    [len(row_ids), capacity] (all tile rows by default) of the rightmost
    window tile column, positions in the window frame, the density at
    absolute x (x + x0_cells).  Thermal noise comes from a CPU generator
    seeded with ``mix_seed(key, row)`` per global tile row, so a sharded
    caller that injects its own rows gets the same plasma, and the card
    the same as the CPU."""
    if row_ids is None:
        row_ids = range(tiling.tile_rows)
    row_ids = [int(r) for r in row_ids]
    per_tile = spec.ppc * tiling.tile_nx * tiling.tile_ny
    # Drawn on the host; one copy to the device, from pinned memory when
    # that is a card, so the step does not wait for it.
    host = [torch.tensor(row_ids, dtype=dtype)[:, None]]
    if any(u > 0 for u in spec.thermal_spread()):
        gen = torch.Generator()
        rows = []
        for r in row_ids:
            gen.manual_seed(mix_seed(key, r))
            rows.append(torch.randn((3, per_tile), generator=gen,
                                    dtype=dtype))
        host.append(torch.stack(rows, dim=1))  # [3, rows, per_tile]
    if torch.device(device).type == "cuda":
        host = [a.pin_memory() for a in host]
    trow, *noise = (a.to(device, non_blocking=True) for a in host)

    def draw(axis, shape):
        return noise[0][axis]

    tcol = torch.full((len(row_ids), 1), float(tiling.tile_cols - 1),
                      dtype=dtype, device=device)
    return _load_buckets(spec, domain, tiling, capacity, trow, tcol,
                         float(x0_cells), dtype, device, draw)
