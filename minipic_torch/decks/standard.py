"""Named run decks (torch port of ``minipic_tpu.decks.standard``).

Each case bundles a Deck with its initial fields (``init_fields``) and its
state seeder (``seed_state``: perturbations applied after loading, e.g.
the two-stream velocity seed), either of which may be None.  The port
carries, with the JAX package's fields, sizes, field inits and seeders:
the reference's fields-only pulse (``reference_pulse``), the three
periodic physics decks (``two_stream``, ``weibel``, ``landau``) and the
two laser decks between absorbing walls (``laser_plasma``, and
``laser_wakefield_window`` in a moving window), and the three
``load_balance_*`` decks of the 2 x 4 device mesh (``mesh_shape``), which
run through ``parallel.step.ShardedSimulation`` or
``parallel.balanced.BalancedSimulation``.

Run one on the card::

    from minipic_torch.decks import standard
    from minipic_torch.simulation import Simulation

    case = standard.make("laser_plasma")
    sim = Simulation(case.deck, fields=case.init_fields(case.deck))
    sim.run()

(``case.simulation()`` does the same, and applies ``seed_state``;
``case.simulation(layout="sharded")`` or ``"balanced"`` starts a
multi-device simulation.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from ..core.config import Deck, SpeciesSpec
from ..fields import init as finit


@dataclasses.dataclass
class Case:
    name: str
    deck: Deck
    # (deck, device="cuda") -> FieldState; None: fields start at zero.
    init_fields: Optional[Callable] = None
    seed_state: Optional[Callable] = None  # (state, deck) -> state

    def simulation(self, seed: int = 0, device="cuda", layout: str = "single",
                   devices=None):
        """The deck's simulation as its users start it: the initial fields, the
        species loaded from `seed`, then ``seed_state``.  `layout`
        "single" is ``Simulation`` on `device`; "sharded" and "balanced"
        are the multi-device simulations on `devices` (default: the deck's mesh
        on the cards, or every shard on `device` when it is not
        "cuda")."""
        from ..simulation import Simulation

        fields = (None if self.init_fields is None
                  else self.init_fields(self.deck, device=device))
        if layout == "single":
            sim = Simulation(self.deck, fields=fields, seed=seed,
                             device=device)
        else:
            from ..parallel.balanced import BalancedSimulation
            from ..parallel.step import ShardedSimulation

            cls = {"sharded": ShardedSimulation,
                   "balanced": BalancedSimulation}[layout]
            on_all = None if torch.device(device).type == "cuda" else device
            sim = cls(self.deck, fields=fields, seed=seed, devices=devices,
                      device=on_all)
        if self.seed_state is not None:
            sim.state = self.seed_state(sim.state, self.deck)
        return sim


def _fit_tile(n: int, target: int = 25) -> int:
    """Largest divisor of n that is <= target (tile sizes must divide the
    grid)."""
    for t in range(min(target, n), 0, -1):
        if n % t == 0:
            return t
    return 1


def reference_pulse(nx: int = 450, ny: int = 450) -> Case:
    """The reference's canonical run: 10x10 box, 450^2 cells, the cos^2
    pulse (Test 3), dt = 0.5 dt_CFL, save every 25; fields only."""
    deck = Deck(box_x=10.0, box_y=10.0, nx=nx, ny=ny,
                tile_nx=_fit_tile(nx), tile_ny=_fit_tile(ny),
                sim_time=500.0, save_frequency=25)

    def fields(d, device="cuda"):
        return finit.pulse_x(d.domain, dtype=d.dtype, device=device)

    return Case("reference_pulse", deck, init_fields=fields)


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


def laser_plasma(nx: int = 512, ny: int = 512, ppc: int = 4) -> Case:
    """BASELINE config 4: a Gaussian laser (a0 = 2) into an underdense slab
    with a soft ramp from x = 15, between absorbing walls; CIC, 16x16
    tiles, guard 2, the f32 deposit (the slab's graded weights make the
    int8 deposit ineligible)."""
    box = 51.2

    def slab(x, y):
        return 0.05 * 0.5 * (1.0 + torch.tanh((x - 15.0) / 2.0))

    deck = Deck(
        box_x=box, box_y=box, nx=nx, ny=ny, tile_nx=16, tile_ny=16,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.01,
                        density=slab),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc,
                        density=slab),
        ),
        boundary="absorbing", absorb_width=24, sim_time=60.0,
    )

    def fields(d, device="cuda"):
        return finit.gaussian_laser_x(d.domain, a0=2.0, k0=10.0,
                                      x_center=6.0, length=3.0, waist=8.0,
                                      dtype=d.dtype, device=device)

    return Case("laser_plasma", deck, init_fields=fields)


def laser_wakefield_window(nx: int = 512, ny: int = 256,
                           ppc: int = 4) -> Case:
    """laser_plasma's scenario in a window that follows the pulse at c: a
    long upramp (x = 30-50, absolute) into an n = 0.3 plateau enters at the
    leading edge, depleted plasma leaves behind; TSC, 8x8 tiles, guard 4,
    whole-bucket chunks, the f32 deposit."""
    box_x, box_y = 51.2, 25.6

    def profile(x, y):
        return 0.3 * 0.5 * (1.0 + torch.tanh((x - 40.0) / 4.0))

    deck = Deck(
        box_x=box_x, box_y=box_y, nx=nx, ny=ny, tile_nx=8, tile_ny=8,
        guard=4, kchunk=0,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.01,
                        density=profile, shape_order=2),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc,
                        density=profile, shape_order=2),
        ),
        boundary="absorbing", absorb_width=16, moving_window=True,
        sim_time=200.0,
    )

    def fields(d, device="cuda"):
        return finit.gaussian_laser_x(d.domain, a0=2.0, k0=5.0,
                                      x_center=40.0, length=4.0, waist=10.0,
                                      dtype=d.dtype, device=device)

    return Case("laser_wakefield_window", deck, init_fields=fields)


def load_balance_stress(nx: int = 1024, ny: int = 1024,
                        n_particles: float = None) -> Case:
    """BASELINE config 5: a density blob on a 1024^2 grid, 1e8 particles a
    species, on the 2 x 4 mesh.  Weighted loading: the blob concentrates
    weight while the particle counts stay uniform per tile, so per-shard
    work starts balanced; this deck stresses the capacity and weight axis
    (graded weights: the f32 deposit)."""
    if n_particles is None:
        n_particles = 95.0 * nx * ny  # 1e8 at the nominal 1024^2
    ppc = max(1, round(n_particles / (nx * ny)))

    def blob(x, y):
        r2 = ((x - 51.2) ** 2 + (y - 51.2) ** 2) / (12.0 ** 2)
        return 0.1 + 4.0 * torch.exp(-r2)

    deck = Deck(
        box_x=102.4, box_y=102.4, nx=nx, ny=ny, tile_nx=8, tile_ny=8,
        guard=4, kchunk=0,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.05,
                        density=blob),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc,
                        density=blob),
        ),
        sim_time=10.0, mesh_shape=(2, 4),
    )
    return Case("load_balance_stress", deck)


def load_balance_stress_counts(nx: int = 1024, ny: int = 1024,
                               ppc: int = 95) -> Case:
    """load_balance_stress's blob loaded in count mode: uniform weights,
    per-cell live counts following the 0.1..4.1 profile (a ~41x contrast),
    so per-shard work contrasts for real: on the 2 x 4 mesh the blob's
    shards are the stragglers (``RunHistory.live_skew``); striped placement
    is the fix.  n_max is declared, so the weight is global and the int8
    deposit is eligible."""

    def blob(x, y):
        r2 = ((x - 51.2) ** 2 + (y - 51.2) ** 2) / (12.0 ** 2)
        return 0.1 + 4.0 * torch.exp(-r2)

    deck = Deck(
        box_x=102.4, box_y=102.4, nx=nx, ny=ny, tile_nx=8, tile_ny=8,
        guard=4, kchunk=0, deposit="int8",
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.05,
                        density=blob, load_mode="count", n_max=4.1),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc,
                        density=blob, load_mode="count", n_max=4.1),
        ),
        sim_time=10.0, mesh_shape=(2, 4),
    )
    return Case("load_balance_stress_counts", deck)


def load_balance_bunching(nx: int = 512, ny: int = 512,
                          ppc: int = 64) -> Case:
    """A drifting count-loaded blob sweeps across the shard seams, so the
    straggler moves from shard to shard: block placement cannot rebalance
    it (the reference migrates tiles off hot ranks for this,
    PIC_2D.cpp:398-412), striped placement holds the skew near 1."""

    def blob(x, y):
        r2 = ((x - 12.8) ** 2 + (y - 25.6) ** 2) / (8.0 ** 2)
        return 0.05 + 4.0 * torch.exp(-r2)

    deck = Deck(
        box_x=51.2, box_y=51.2, nx=nx, ny=ny, tile_nx=8, tile_ny=8, guard=4,
        kchunk=0, deposit="int8",
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, ux=0.5,
                        uth=0.02, density=blob, load_mode="count",
                        n_max=4.05),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc, ux=0.5,
                        uth=0.02, density=blob, load_mode="count",
                        n_max=4.05),
        ),
        sim_time=120.0, mesh_shape=(2, 4),
    )
    return Case("load_balance_bunching", deck)


CASES: Dict[str, Callable[..., Case]] = {
    "reference_pulse": reference_pulse,
    "two_stream": two_stream,
    "weibel": weibel,
    "landau": landau,
    "laser_plasma": laser_plasma,
    "laser_wakefield_window": laser_wakefield_window,
    "load_balance_stress": load_balance_stress,
    "load_balance_stress_counts": load_balance_stress_counts,
    "load_balance_bunching": load_balance_bunching,
}


def make(name: str, **overrides) -> Case:
    if name not in CASES:
        raise KeyError(f"unknown deck '{name}'; available: {sorted(CASES)}")
    return CASES[name](**overrides)
