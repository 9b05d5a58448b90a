"""The inputs of a cell, made from its seed: each species' particles in the
tile-bucket layout the program takes, and the initial fields.

A frozen copy of the port's quiet-start loader (``_load_buckets`` of
``minipic_torch/particles/species.py``, its weight and count modes: here
``lattice_buckets``, which the moving window's injection in
``reference/window.py`` also takes) and of the field inits
(``gaussian_laser_x`` and ``pulse_x`` of ``minipic_torch/fields/init.py``),
with the density profiles that configuration files name.  It imports
nothing of the program: the program and the reference are handed the same
tensors.

* Positions: ``ppc`` particles a cell on the lattice (i + (m+1/2)/ppc_x,
  j + (n+1/2)/ppc_y), in global cell units, tile by tile.
* Weights (``load_mode`` "weight"): w = n dx dy / ppc, n the species'
  density profile (1 without).
* Weights (``load_mode`` "count", with a profile): one weight n_max dx dy /
  ppc (n_max the species' ``n_max``, else the profile's largest value), a
  particle kept where its sub-cell rank (m ppc_x + l + 1/2) / ppc is below
  n / n_max, so the live count a cell follows the profile; each bucket is
  then live-compacted (live slots first, in load order).
* Momenta: drift + per-axis Gaussian spread, drawn on the device from one
  ``torch.Generator`` seeded with the run's seed, one call an axis, for
  every lattice slot before the compaction.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

FIELD_NAMES = ("ex", "ey", "ez", "bx", "by", "bz")
CHANNELS = ("x", "y", "px", "py", "pz", "w")
# Yee stagger (x, y) of each field component in cells.
STAGGER = {"ex": (0.5, 0.0), "ey": (0.0, 0.5), "ez": (0.0, 0.0),
           "bx": (0.0, 0.5), "by": (0.5, 0.0), "bz": (0.5, 0.5)}


def _tanh_ramp(n0: float, x0: float, width: float) -> Callable:
    """n0 (1 + tanh((x - x0) / width)) / 2, x in physical units."""
    def density(x, y):
        return n0 * 0.5 * (1.0 + torch.tanh((x - x0) / width))
    return density


def _gaussian_blob(base: float, amp: float, x0: float, y0: float,
                   radius: float) -> Callable:
    """base + amp exp(-((x - x0)^2 + (y - y0)^2) / radius^2)."""
    def density(x, y):
        r2 = ((x - x0) ** 2 + (y - y0) ** 2) / (radius ** 2)
        return base + amp * torch.exp(-r2)
    return density


PROFILES: Dict[str, Callable[..., Callable]] = {
    "tanh_ramp": _tanh_ramp, "gaussian_blob": _gaussian_blob}


def density_profile(spec: Optional[dict]) -> Optional[Callable]:
    """The density callable n(x, y) a species entry names, or None for a
    uniform density 1."""
    if spec is None:
        return None
    args = {k: v for k, v in spec.items() if k != "profile"}
    return PROFILES[spec["profile"]](**args)


def seeded_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def _lattice_factors(ppc: int) -> Tuple[int, int]:
    a = int(math.isqrt(ppc))
    while ppc % a != 0:
        a -= 1
    return a, ppc // a  # (per-x, per-y)


def lattice_buckets(sp: dict, deck: dict, trow: torch.Tensor,
                    tcol: torch.Tensor, x_abs_offset: float, dtype, device,
                    draw: Callable) -> Tuple[torch.Tensor, ...]:
    """(x, y, px, py, pz, w), each [B, ppc * tile cells], of species entry
    `sp` on the lattice of the tiles at (trow, tcol) ([B, 1] each, tile
    coordinates in the deck's frame); the density sees x + x_abs_offset
    (cells).  ``draw(axis, shape)`` gives the unit normals of momentum axis
    0, 1 or 2, called only for an axis with a thermal spread, in axis
    order.  A count-loaded bucket comes live-compacted."""
    nxt, nyt = deck["tile_nx"], deck["tile_ny"]
    dx, dy = deck["box_x"] / deck["nx"], deck["box_y"] / deck["ny"]
    ppc = sp["ppc"]
    ppc_x, ppc_y = _lattice_factors(ppc)
    per_tile = ppc * nxt * nyt
    slots = torch.arange(per_tile, device=device)
    l = slots % ppc_x
    m = (slots // ppc_x) % ppc_y
    cell = slots // (ppc_x * ppc_y)
    xi = (cell % nxt).to(dtype) + (l.to(dtype) + 0.5) / ppc_x
    eta = (cell // nxt).to(dtype) + (m.to(dtype) + 0.5) / ppc_y
    x = tcol * nxt + xi[None, :]
    y = trow * nyt + eta[None, :]
    density = density_profile(sp.get("density"))
    if density is None:
        n = torch.ones_like(x)
    else:
        x_abs = x + x_abs_offset
        n = torch.as_tensor(density(x_abs * dx, y * dy), dtype=dtype,
                            device=device)
    count = sp.get("load_mode", "weight") == "count" and density is not None
    if count:
        n_max = (torch.tensor(sp["n_max"], dtype=dtype, device=device)
                 if sp.get("n_max") is not None else n.max())
        sub_rank = ((m * ppc_x + l).to(dtype) + 0.5) / ppc
        keep = sub_rank[None, :] < (n / torch.clamp(n_max, min=1e-30))
        w = torch.where(keep, n_max * (dx * dy / ppc), torch.zeros_like(n))
    else:
        w = n * (dx * dy / ppc)
    shape = (trow.shape[0], per_tile)
    moms = []
    for axis, (uth, drift) in enumerate(zip(
            thermal_spread(sp), (sp.get("ux", 0.0), sp.get("uy", 0.0),
                                 sp.get("uz", 0.0)))):
        if uth <= 0:
            moms.append(torch.full(shape, drift, dtype=dtype, device=device))
        else:
            moms.append(draw(axis, shape) * uth + drift)
    chans = [x, y, *moms, w]
    if count:
        order = torch.sort((w <= 0).to(torch.int8), dim=1,
                           stable=True).indices
        chans = [torch.gather(a, 1, order) for a in chans]
    return tuple(a.to(dtype) for a in chans)


def thermal_spread(sp: dict) -> Tuple[float, float, float]:
    """The species' thermal spread along x, y and z."""
    return tuple(sp.get("uth", 0.0) if sp.get(k) is None else sp[k]
                 for k in ("uth_x", "uth_y", "uth_z"))


def load_species(sp: dict, deck: dict, capacity: int,
                 gen: torch.Generator, dtype, device) -> Tuple[torch.Tensor,
                                                               ...]:
    """(x, y, px, py, pz, w), each [tiles, capacity], for species entry
    `sp` of configuration deck `deck`; slots past ppc * tile cells are
    empty (all zero)."""
    tile_cols = deck["nx"] // deck["tile_nx"]
    tiles = tile_cols * (deck["ny"] // deck["tile_ny"])
    per_tile = sp["ppc"] * deck["tile_nx"] * deck["tile_ny"]
    if per_tile > capacity:
        raise ValueError(f"capacity {capacity} < ppc * tile cells "
                         f"{per_tile}")
    t = torch.arange(tiles, device=device)
    tcol = (t % tile_cols).to(dtype)[:, None]
    trow = (t // tile_cols).to(dtype)[:, None]

    def draw(axis, shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    chans = lattice_buckets(sp, deck, trow, tcol, 0.0, dtype, device, draw)
    pad = capacity - per_tile
    return tuple(torch.nn.functional.pad(a, (0, pad)) for a in chans)


def _gaussian_laser_x(deck: dict, a0: float, k0: float, x_center: float,
                      length: float, waist: float) -> Dict[str, Callable]:
    yc = deck["box_y"] / 2.0

    def prof(x, y):
        env = torch.exp(-(((x - x_center) / length) ** 2)
                        - (((y - yc) / waist) ** 2))
        return a0 * torch.sin(k0 * x) * env

    return {"ey": prof, "bz": prof}


def _pulse_x(deck: dict, amplitude: float, modes: int, center: float,
             tau: float) -> Dict[str, Callable]:
    """The reference's Test 3: Ey = Bz = A sin(kx x) cos^2((x - xc) / tau
    pi / 2) on |x - xc| <= tau, 0 elsewhere, kx = modes 2 pi / box_x."""
    kx = modes * 2.0 * math.pi / deck["box_x"]

    def ey(x, y):
        u = (x - center) / tau
        env = torch.where(torch.abs(u) <= 1.0,
                          torch.cos(u * math.pi * 0.5) ** 2,
                          torch.zeros_like(u))
        return amplitude * torch.sin(kx * x) * env

    return {"ey": ey, "bz": ey}


FIELD_INITS: Dict[str, Callable[..., Dict[str, Callable]]] = {
    "zeros": lambda deck: {},
    "gaussian_laser_x": _gaussian_laser_x,
    "pulse_x": _pulse_x,
}


def init_fields(spec: dict, deck: dict, dtype, device) -> Tuple[torch.Tensor,
                                                               ...]:
    """The six (ny, nx) field components of field init `spec` ({"init":
    name, ...its parameters}), each at its Yee stagger."""
    args = {k: v for k, v in spec.items() if k != "init"}
    exprs = FIELD_INITS[spec["init"]](deck, **args)
    nx, ny = deck["nx"], deck["ny"]
    dx, dy = deck["box_x"] / nx, deck["box_y"] / ny
    out = []
    for name in FIELD_NAMES:
        fn = exprs.get(name)
        if fn is None:
            out.append(torch.zeros((ny, nx), dtype=dtype, device=device))
            continue
        ox, oy = STAGGER[name]
        x = (torch.arange(nx, dtype=dtype, device=device) + ox) * dx
        y = (torch.arange(ny, dtype=dtype, device=device) + oy) * dy
        v = torch.as_tensor(fn(x[None, :], y[:, None]), dtype=dtype,
                            device=device)
        out.append(v.expand(ny, nx).contiguous())
    return tuple(out)
