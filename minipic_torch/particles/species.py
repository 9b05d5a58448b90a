"""Species loading: quiet-start lattice positions, profile weights, thermal
momenta — the torch form of ``minipic_tpu.particles.species.load_species``.

* Positions: ppc macroparticles per cell on the lattice
  (i + (m+1/2)/ppc_x, j + (n+1/2)/ppc_y).
* Weights: w = n dxdy / ppc, or (load_mode="count") a uniform weight with
  per-cell live counts thinned to the profile, buckets live-compacted.
* Momenta: drift + per-axis Gaussian spread drawn from the caller's
  ``torch.Generator`` (the JAX package's random stream cannot be
  reproduced, so loads agree with it in distribution, not bit for bit).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.config import SpeciesSpec
from ..core.geometry import Domain, Tiling
from ..core.state import ParticleState


def _lattice_factors(ppc: int) -> Tuple[int, int]:
    a = int(math.isqrt(ppc))
    while ppc % a != 0:
        a -= 1
    return a, ppc // a  # (per-x, per-y)


def load_species(spec: SpeciesSpec, domain: Domain, tiling: Tiling,
                 capacity: int, generator: torch.Generator,
                 dtype: torch.dtype, device: torch.device) -> ParticleState:
    """Tile-bucketed ParticleState [num_tiles, capacity] for one species;
    `generator` must live on `device`."""
    ppc_x, ppc_y = _lattice_factors(spec.ppc)
    nxt, nyt = tiling.tile_nx, tiling.tile_ny
    per_tile = spec.ppc * nxt * nyt
    if per_tile > capacity:
        raise ValueError(f"capacity {capacity} < ppc*tile cells = {per_tile}")
    nb = tiling.num_tiles

    slots = torch.arange(per_tile, device=device)
    l = slots % ppc_x
    m = (slots // ppc_x) % ppc_y
    cell = slots // (ppc_x * ppc_y)
    xi = (cell % nxt).to(dtype) + (l.to(dtype) + 0.5) / ppc_x
    eta = (cell // nxt).to(dtype) + (m.to(dtype) + 0.5) / ppc_y
    t = torch.arange(nb, device=device)
    tcol = (t % tiling.tile_cols).to(dtype)[:, None]
    trow = (t // tiling.tile_cols).to(dtype)[:, None]
    x = tcol * nxt + xi[None, :]
    y = trow * nyt + eta[None, :]

    count_mode = spec.load_mode == "count" and spec.density is not None
    if spec.density is None:
        n = torch.ones_like(x)
    else:
        n = torch.as_tensor(spec.density(x * domain.dx, y * domain.dy),
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

    def mom(uth, drift):
        if uth <= 0:
            return torch.full(shape, drift, dtype=dtype, device=device)
        r = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        return r * uth + drift

    ux, uy, uz = spec.thermal_spread()
    px, py, pz = mom(ux, spec.ux), mom(uy, spec.uy), mom(uz, spec.uz)
    chans = [x, y, px, py, pz, w]
    if count_mode:
        # Live-compact each bucket (stable: live slots first, load order
        # kept) so the advance's live-count bound holds from step 0.
        order = torch.sort((w <= 0).to(torch.int8), dim=1, stable=True).indices
        chans = [torch.gather(a, 1, order) for a in chans]
    pad = capacity - per_tile
    return ParticleState(*(torch.nn.functional.pad(a.to(dtype), (0, pad))
                           for a in chans))
