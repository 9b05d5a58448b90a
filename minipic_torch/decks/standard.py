"""Named run decks (torch port of ``minipic_tpu.decks.standard``).

Each case bundles a Deck with its state seeder (perturbations applied
after loading, e.g. the two-stream velocity seed).
The port carries the three periodic physics decks of BASELINE.json:
``two_stream``, ``weibel`` and ``landau``, with the JAX package's fields,
sizes and seeders.  The other six named decks need modules not ported yet;
``make`` raises ``NotImplementedError`` for them, naming the ROADMAP item.

Run one on the card::

    from minipic_torch.decks import standard
    from minipic_torch.simulation import Simulation

    case = standard.make("two_stream")
    sim = Simulation(case.deck)
    sim.state = case.seed_state(sim.state, case.deck)
    sim.run()
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch

from ..core.config import Deck, SpeciesSpec


@dataclasses.dataclass
class Case:
    name: str
    deck: Deck
    seed_state: Callable  # (state, deck) -> state


def _fit_tile(n: int, target: int = 25) -> int:
    """Largest divisor of n that is <= target (tile sizes must divide the
    grid)."""
    for t in range(min(target, n), 0, -1):
        if n % t == 0:
            return t
    return 1


def two_stream(nx: int = 64, ny: int = 64, ppc: int = 16,
               u0: float = 0.2) -> Case:
    """BASELINE config 1: two-stream instability, TSC shapes, 8x8 tiles,
    guard 4, whole-bucket chunks, int8 deposit."""
    lx = 2 * math.pi * u0 / 0.45  # mode 1 near peak growth
    deck = Deck(
        box_x=lx, box_y=lx * ny / nx, nx=nx, ny=ny, tile_nx=8, tile_ny=8,
        guard=4, kchunk=0, deposit="int8",
        species=(
            SpeciesSpec("right", charge=-1.0, mass=1.0, ppc=ppc, ux=u0,
                        shape_order=2),
            SpeciesSpec("left", charge=-1.0, mass=1.0, ppc=ppc, ux=-u0,
                        shape_order=2),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc,
                        shape_order=2),
        ),
        sim_time=80.0,
    )

    def seed(state, d):
        k1 = 2 * math.pi / d.box_x
        sp = list(state.species)
        for i in (0, 1):
            p = sp[i]
            sp[i] = p._replace(w=p.w * 0.5,
                               px=p.px + 1e-3 * torch.sin(k1 * p.x * d.dx))
        return state._replace(species=tuple(sp))

    return Case("two_stream", deck, seed_state=seed)


def weibel(nx: int = 128, ny: int = 128, ppc: int = 16,
           uz: float = 0.6) -> Case:
    """BASELINE config 2: Weibel instability — counter-streaming along z;
    the anisotropy drives in-plane magnetic filaments."""
    deck = Deck(
        box_x=12.8, box_y=12.8, nx=nx, ny=ny, tile_nx=8, tile_ny=8,
        guard=4, kchunk=0, deposit="int8",
        species=(
            SpeciesSpec("up", charge=-1.0, mass=1.0, ppc=ppc, uz=uz,
                        uth=0.01, shape_order=2),
            SpeciesSpec("down", charge=-1.0, mass=1.0, ppc=ppc, uz=-uz,
                        uth=0.01, shape_order=2),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc,
                        shape_order=2),
        ),
        sim_time=60.0,
    )

    def seed(state, d):
        sp = list(state.species)
        for i in (0, 1):
            sp[i] = sp[i]._replace(w=sp[i].w * 0.5)
        return state._replace(species=tuple(sp))

    return Case("weibel", deck, seed_state=seed)


def landau(nx: int = 256, ny: int = 256, ppc: int = 16) -> Case:
    """BASELINE config 3: Landau damping with TSC shapes, k lambda_D =
    0.35: the Langmuir wave damps while total energy stays conserved."""
    uth = 0.05
    klam = 0.35
    k = klam / uth  # k lambda_D = k uth / wp
    lx = 2 * math.pi / k
    deck = Deck(
        box_x=lx, box_y=lx, nx=nx, ny=ny, tile_nx=8, tile_ny=8, guard=4,
        kchunk=0, deposit="int8",
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=uth,
                        shape_order=2),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc, uth=0.0,
                        shape_order=2),
        ),
        sim_time=40.0,
    )

    def seed(state, d):
        k1 = 2 * math.pi / d.box_x
        sp = list(state.species)
        p = sp[0]
        sp[0] = p._replace(px=p.px + 0.1 * uth * torch.sin(k1 * p.x * d.dx))
        return state._replace(species=tuple(sp))

    return Case("landau", deck, seed_state=seed)


CASES: Dict[str, Callable[..., Case]] = {
    "two_stream": two_stream,
    "weibel": weibel,
    "landau": landau,
}

# The JAX package's other named decks, and the ROADMAP item each waits for.
UNPORTED: Dict[str, str] = {
    "reference_pulse": "ROADMAP A2 (fields/init.py: the pulse)",
    "laser_plasma": "ROADMAP A2 (fields/boundary.py absorbing boundaries, "
                    "fields/init.py: the Gaussian laser)",
    "laser_wakefield_window": "ROADMAP A3/A4 (the moving window, "
                              "inject_column) and A2",
    "load_balance_stress": "ROADMAP A9 (the 2x4 device mesh)",
    "load_balance_stress_counts": "ROADMAP A9 (the 2x4 device mesh)",
    "load_balance_bunching": "ROADMAP A9 (the 2x4 device mesh)",
}


def make(name: str, **overrides) -> Case:
    if name in UNPORTED:
        raise NotImplementedError(f"deck '{name}' is not ported yet: "
                                  f"{UNPORTED[name]}")
    if name not in CASES:
        raise KeyError(f"unknown deck '{name}'; available: "
                       f"{sorted(CASES) + sorted(UNPORTED)}")
    return CASES[name](**overrides)
