"""Single-device simulation: the full PIC step on one device.

Torch port of ``minipic_tpu.simulation`` for periodic decks.  Step order
(leapfrog, E and B synchronized at integer steps):

  1. halo-pad the fields at t^n and cut the per-tile windows;
  2. per species, the advance (ops/advance.py): gather E^n, B^n -> Boris
     u^{n-1/2} -> u^{n+1/2} -> move x^n -> x^{n+1} (stored wrapped) ->
     Esirkepov J^{n+1/2} tile windows, and each tile's max displacement;
  3. fold the J windows into the global J;
  4. B^n -> B^{n+1/2} -> E^{n+1} (with J) -> B^{n+1};
  5. re-bin when the drift trigger or the interval schedule fires:
     ``binning.rebin_auto`` for ``rebin_mode`` "auto" and "incremental" on
     both devices (the split, then the deal route where the buckets hold
     eight segment runs + 256 slots, else the sort route of the movers and
     append_incoming; the defrag when headroom is short), the full sort
     (``binning.rebin``) for "sort" or a deck whose buckets are too small
     for a mover buffer.

What this port does not carry yet raises ``NotImplementedError``:
absorbing boundaries and the moving window.

Host syncs: the re-bin decision is taken on the host, so each step reads
one device scalar (the drift predicate, or the schedule's on the interval
trigger).  The re-bin itself reads nothing back: its force flag, its
append-or-defrag choice and the drift reset stay on the device.
``Simulation.run`` adds one read on each step that re-binned (its overflow,
zero on every other step) and the census every ``CAPACITY_CHECK_EVERY``
steps.

Profiler ranges (``torch.profiler.record_function``) name the step's
layers for a trace: ``minipic.fields`` (pad, window extract, J fold, Yee),
``minipic.advance`` (the kernel and its epilogue), ``minipic.rebin`` and
``minipic.diag`` (energies, momentum, live count, weight guard).
"""
from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from .core.config import Deck
from .core.state import (
    CurrentState,
    FieldState,
    ParticleState,
    SimState,
    field_energy,
    kinetic_energy,
    momentum_sum,
)
from .fields.halo import fold_block_periodic, pad_fields_periodic
from .fields.tiles import extract_field_tiles, fold_tiles
from .fields.yee import update_b_half_periodic, update_e_full_periodic
from .ops.advance import fused_push_deposit, live_watermark, resolve_mode
from .particles.binning import rebin, rebin_auto
from .particles.species import load_species

# Bucket capacity quantum for whole-bucket chunks (kchunk=0), as in the JAX
# package (whose re-bin kernels slice buckets in 512-slot blocks).
BUCKET_ALIGN = 512
# Steps between two census checks in Simulation.run (the JAX package's
# CapacityManager cadence; an overflow is acted on at once).
CAPACITY_CHECK_EVERY = 50


def align_capacity(deck: Deck, cap: int) -> int:
    """`cap` rounded up to the bucket quantum: kchunk, or BUCKET_ALIGN for
    whole-bucket chunks."""
    q = deck.kchunk if deck.kchunk > 0 else BUCKET_ALIGN
    return -(-cap // q) * q


def bucket_capacity(deck: Deck) -> int:
    """Slots per tile bucket: the deck's capacity rounded up to the chunk
    (kchunk, or BUCKET_ALIGN for whole-bucket chunks)."""
    return align_capacity(deck, deck.capacity())


def uses_rebin_auto(deck: Deck) -> bool:
    """"auto" and "incremental" re-bin by ``rebin_auto`` on every device
    (the JAX package's "auto" does so on its Pallas backend only)."""
    return deck.rebin_mode in ("auto", "incremental")


def rebin_caps(deck: Deck, capacity: int) -> Tuple[int, int]:
    """(mover buffer, segment run) slots per tile for ``rebin_auto``, or
    (0, 0) when the buckets are too small for a mover buffer and the full
    sort re-bins instead.  ``rebin_auto`` takes the deal route only when
    ``capacity >= 8 * run + 256``, the sort route of the movers below."""
    if not uses_rebin_auto(deck):
        return 0, 0
    mc = deck.mover_cap(capacity)
    if mc == 0:
        return 0, 0
    return mc, deck.mover_seg_cap(mc)


class StepDiag(NamedTuple):
    """Per-step observables, left on the device (reading them syncs)."""

    field_energy: torch.Tensor  # float64
    kinetic_energy: torch.Tensor  # [n_species] float64
    overflow: torch.Tensor  # int32: particles dropped at re-bin
    momentum: torch.Tensor  # [n_species, 3] float64
    shard_live: torch.Tensor  # [1] live particles, all species
    weight_nonuniform: torch.Tensor  # int32: int8 species with uneven w
    rebinned: bool  # host: this step re-binned (overflow is 0 otherwise)


def int8_weight_violations(deck: Deck, species_states) -> torch.Tensor:
    """Count int8-engaged species whose LIVE weights are not uniform: the
    int8 deposit scales jx/jy by q*max(w), right only for uniform w."""
    dev = species_states[0].w.device if species_states else None
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    if deck.deposit != "int8":
        return bad
    for spec, p in zip(deck.species, species_states):
        if not spec.uniform_weights():
            continue
        wmax = p.w.max()
        inf = torch.full_like(p.w, float("inf"))
        wmin = torch.where(p.w > 0, p.w, inf).min()
        bad = bad + ((wmin != wmax) & torch.isfinite(wmin)).to(torch.int32)
    return bad


def tile_origins(tiling, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """([T,1], [T,1]) global cell coordinates of each tile's origin."""
    t = torch.arange(tiling.num_tiles, device=device)
    ox = (t % tiling.tile_cols).to(dtype)[:, None] * tiling.tile_nx
    oy = (t // tiling.tile_cols).to(dtype)[:, None] * tiling.tile_ny
    return ox, oy


def tile_local_coords(x, y, origins, tile_nx: int, tile_ny: int,
                      grid: Optional[Tuple[int, int]] = None):
    """Bucket-tile-local coordinates with nearest-image centering.

    The fold is a reciprocal multiply, not a division — the same f32 ops as
    the advance's fold, so diagnostics (rho for continuity) evaluate shapes
    at the coordinates the deposit used; the int8 deposit's exactness
    check depends on it."""
    ox, oy = origins
    xi = x - ox
    eta = y - oy
    if grid is not None:
        gnx, gny = grid
        xi = xi - gnx * torch.floor((xi + (gnx - tile_nx) * 0.5) * (1.0 / gnx))
        eta = eta - gny * torch.floor((eta + (gny - tile_ny) * 0.5)
                                      * (1.0 / gny))
    return xi, eta


def max_step_displacement(species_states, dt: float, dx: float,
                          dy: float) -> torch.Tensor:
    """Largest per-axis displacement (cells) of any live particle, from the
    pushed momenta (float32 0-d)."""
    disp = None
    for p in species_states:
        inv_g = torch.rsqrt(1.0 + p.px * p.px + p.py * p.py + p.pz * p.pz)
        m = torch.maximum(torch.abs(p.px) * (dt / dx),
                          torch.abs(p.py) * (dt / dy))
        m = torch.where(p.w > 0, m * inv_g, torch.zeros_like(m))
        d = m.max().to(torch.float32)
        disp = d if disp is None else torch.maximum(disp, d)
    return disp


def resolve_backend(deck: Deck, device: torch.device) -> str:
    """"cuda" (the advance kernel) for a CUDA device, "plain" on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not "
                               "available")
        if deck.dtype != torch.float32:
            raise NotImplementedError("the CUDA advance kernel is float32-only")
        return "cuda"
    if device.type == "cpu":
        return "plain"
    raise NotImplementedError(f"device {device}")


def advance_species_tiles(p: ParticleState, ftiles: FieldState, *, qm: float,
                          q: float, order: int, tile_ny: int, tile_nx: int,
                          tile_cols: int, g: int, dt: float, dx: float,
                          dy: float, grid: Tuple[int, int], mode: str):
    """Gather + push + move + deposit for one species over its buckets.
    Returns (pushed particles with wrapped positions, (jx, jy, jz) tile
    windows, max displacement in cells)."""
    return fused_push_deposit(
        p, ftiles, live_watermark(p.w), qm=qm, q=q, order=order,
        tile_ny=tile_ny, tile_nx=tile_nx, tile_cols=tile_cols, g=g, dt=dt,
        dx=dx, dy=dy, grid=grid, mode=mode)


def _check_supported(deck: Deck) -> None:
    if deck.boundary != "periodic":
        raise NotImplementedError(f"boundary={deck.boundary!r}")
    if deck.moving_window:
        raise NotImplementedError("moving_window")


def build_step(deck: Deck, device: torch.device):
    """Step function SimState -> (SimState, StepDiag) for `device`.

    ``MINIPIC_APPEND_FUSED`` is read here, once: "0" appends the deal
    route's arrivals with append_runs after a roll, anything else (the
    default "1") with the fused append."""
    deck.validate()
    _check_supported(deck)
    resolve_backend(deck, device)
    fused = os.environ.get("MINIPIC_APPEND_FUSED", "1") == "1"
    tiling = deck.tiling
    g = deck.guard
    dt, dx, dy = deck.dt, deck.dx, deck.dy
    grid = (deck.nx, deck.ny)
    trigger_drift = bool(deck.species) and deck.uses_drift_trigger()
    # Interval schedule: when the guard affords one extra CFL step, a
    # mover-buffer overflow defers the tile to the next step instead of
    # dropping at once (the drift trigger's deferral budget).
    interval_grace = uses_rebin_auto(deck) and (
        (deck.rebin_interval + 1) * deck.cfl_step_cells()
        <= deck.guard - deck.shape_reach())
    modes = []
    for spec in deck.species:
        qw0 = (spec.charge * dx * dy / spec.ppc
               if spec.uniform_weights() else 0.0)
        modes.append(resolve_mode(deck.deposit, qw0, tiling.tile_ny,
                                  tiling.tile_nx, g))
        if modes[-1] == "f32" and deck.gather_precision != "exact":
            raise NotImplementedError(
                f"gather_precision={deck.gather_precision!r} with the f32 "
                "deposit (the port gathers exactly)")

    def to_global(t):
        tr = t.reshape(tiling.tile_rows, tiling.tile_cols,
                       tiling.tile_ny + 2 * g, tiling.tile_nx + 2 * g)
        return fold_block_periodic(
            fold_tiles(tr, tiling.tile_ny, tiling.tile_nx, g), g)

    def step(state: SimState) -> Tuple[SimState, StepDiag]:
        f = state.fields
        with record_function("minipic.fields"):
            ftiles = extract_field_tiles(
                pad_fields_periodic(f, g), tiling.tile_rows,
                tiling.tile_cols, tiling.tile_ny, tiling.tile_nx, g)

        pushed, kes, moms, disps = [], [], [], []
        jsum = None
        for spec, mode, p in zip(deck.species, modes, state.species):
            with record_function("minipic.advance"):
                pnew, js, disp = advance_species_tiles(
                    p, ftiles, qm=spec.charge / spec.mass, q=spec.charge,
                    order=spec.shape_order, tile_ny=tiling.tile_ny,
                    tile_nx=tiling.tile_nx, tile_cols=tiling.tile_cols, g=g,
                    dt=dt, dx=dx, dy=dy, grid=grid, mode=mode)
            jsum = js if jsum is None else tuple(
                a + b for a, b in zip(jsum, js))
            pushed.append(pnew)
            disps.append(disp)
            with record_function("minipic.diag"):
                kes.append(kinetic_energy(pnew, spec.mass))
                moms.append(momentum_sum(pnew, spec.mass))

        with record_function("minipic.fields"):
            j = None if jsum is None else CurrentState(*(to_global(t)
                                                         for t in jsum))
            f = update_b_half_periodic(f, dt, dx, dy)
            f = update_e_full_periodic(f, dt, dx, dy, j)
            f = update_b_half_periodic(f, dt, dx, dy)

        dev = f.ex.device
        drift_now = state.drift
        if trigger_drift:
            if state.drift is None:
                raise ValueError("deck uses drift-triggered re-binning but "
                                 "SimState.drift is unset")
            disp = disps[0]
            for d in disps[1:]:
                disp = torch.maximum(disp, d)
            drift_now = state.drift + disp
            do_rebin = bool(drift_now > deck.drift_threshold())
            # Past this line a deferred re-bin may no longer wait: extract
            # with counted drops.  Stays on the device.
            force = drift_now > deck.force_threshold()
        else:
            sched = state.step % deck.rebin_interval == 0
            if interval_grace:
                # The backlog marker rides SimState.drift (0 clean, 1
                # pending): re-bin again next step, then drop and count.
                force = state.drift > 0.5
                sched = sched | force
            else:
                force = True  # no deferral budget in the guard
            do_rebin = deck.rebin_interval == 1 or bool(sched)

        overflow = torch.zeros((), dtype=torch.int32, device=dev)
        pending_total = torch.zeros((), dtype=torch.int32, device=dev)
        binned = []
        for p in pushed:
            if do_rebin:
                with record_function("minipic.rebin"):
                    mc, sc = rebin_caps(deck, p.capacity)
                    if mc > 0:
                        p, ov, pend = rebin_auto(p, tiling, mc, force=force,
                                                 seg_cap=sc, fused=fused)
                        pending_total = pending_total + pend
                    else:
                        p, ov = rebin(p, tiling)
                overflow = overflow + ov
            binned.append(p)
        if do_rebin and trigger_drift:
            # Reset the budget only after a complete re-bin: a backlog
            # keeps it hot so the next step re-triggers and drains it.
            drift_now = torch.where(pending_total == 0,
                                    torch.zeros_like(drift_now), drift_now)
        elif do_rebin and interval_grace:
            drift_now = (pending_total > 0).to(torch.float32)

        with record_function("minipic.diag"):
            live = sum((p.w > 0).sum(dtype=torch.int32) for p in binned)
            diag = StepDiag(
                field_energy=field_energy(f, dx, dy),
                kinetic_energy=(torch.stack(kes) if kes else torch.zeros(
                    0, dtype=torch.float64, device=dev)),
                overflow=overflow,
                momentum=(torch.stack(moms) if moms else torch.zeros(
                    (0, 3), dtype=torch.float64, device=dev)),
                shard_live=torch.as_tensor(live, dtype=torch.int32,
                                           device=dev).reshape(1),
                weight_nonuniform=int8_weight_violations(deck, binned),
                rebinned=do_rebin,
            )
        new_state = SimState(fields=f, species=tuple(binned),
                             step=state.step + 1, drift=drift_now)
        return new_state, diag

    return step


class Simulation:
    """User-facing entry point: holds a deck and a device, builds the initial
    state, owns the step.  The device is the card unless the caller asks
    for another (``device="cpu"`` runs the plain versions)."""

    def __init__(self, deck: Deck, fields: Optional[FieldState] = None,
                 seed: int = 0, *, device="cuda"):
        deck.validate()
        _check_supported(deck)
        self.device = torch.device(device)
        self.backend = resolve_backend(deck, self.device)
        self.deck = deck
        tiling = deck.tiling
        cap = bucket_capacity(deck)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        species = tuple(
            load_species(spec, deck.domain, tiling, cap, gen, deck.dtype,
                         self.device)
            for spec in deck.species)
        if fields is None:
            fields = FieldState.zeros(deck.ny, deck.nx, deck.dtype,
                                      self.device)
        self.state = SimState(
            fields=fields, species=species,
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            drift=torch.zeros((), dtype=torch.float32, device=self.device))
        self._step = build_step(deck, self.device)
        self._capmgrs = None  # per-species CapacityManagers, built lazily
        self.capacity_changes = 0
        self.overflow_total = 0  # particles dropped over `run` calls

    def step(self, n: int = 1) -> Optional[StepDiag]:
        diag = None
        for _ in range(n):
            self.state, diag = self._step(self.state)
        return diag

    def ensure_capacity(self, overflow: int = 0) -> bool:
        """Grow the buckets on overflow or high occupancy, shrink them after
        a calm spell (``parallel.balance.CapacityManager``, one per
        species), keeping the bucket quantum.  A shrink that the positional
        census does not fit yet is deferred.  Returns True if a capacity
        changed; the step takes the new shapes as they come."""
        from .parallel.balance import CapacityManager, census, with_capacity

        if self._capmgrs is None:
            self._capmgrs = [CapacityManager() for _ in self.state.species]
        changed = False
        species = list(self.state.species)
        for i, (p, mgr) in enumerate(zip(species, self._capmgrs)):
            new_cap = mgr.plan(census(p), overflow)
            if new_cap is None:
                continue
            cap = align_capacity(self.deck, new_cap)
            if cap > p.capacity:
                species[i] = with_capacity(p, cap)
                changed = True
            elif cap < p.capacity:
                try:
                    species[i] = with_capacity(p, cap, self.deck.tiling)
                    changed = True
                except ValueError:
                    pass
        if changed:
            self.state = self.state._replace(species=tuple(species))
            self.capacity_changes += 1
        return changed

    def run(self, n_steps: Optional[int] = None,
            save_every: Optional[int] = None,
            saver: Optional[Callable] = None) -> Optional[StepDiag]:
        """Run the deck (``deck.total_steps`` by default) and call
        ``saver(state, step)`` at step 0 and every `save_every` steps
        (``deck.save_frequency`` by default).  The buckets grow on the first
        step that overflows and are checked every CAPACITY_CHECK_EVERY
        steps (``ensure_capacity``), as in the JAX package; only a step that
        re-binned can overflow, so only its overflow is read.
        ``overflow_total`` adds up what was dropped.  Returns the last
        StepDiag."""
        n_steps = self.deck.total_steps if n_steps is None else n_steps
        save_every = (self.deck.save_frequency if save_every is None
                      else save_every)
        if saver is not None:
            saver(self.state, 0)
        diag = None
        for i in range(1, n_steps + 1):
            self.state, diag = self._step(self.state)
            ovf = int(diag.overflow) if diag.rebinned else 0
            self.overflow_total += ovf
            if ovf > 0 or i % CAPACITY_CHECK_EVERY == 0:
                self.ensure_capacity(ovf)
            if saver is not None and i % save_every == 0:
                saver(self.state, i)
        return diag
