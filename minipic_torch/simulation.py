"""Single-device simulation: the full PIC step on one device.

Torch port of ``minipic_tpu.simulation``.  Step order (leapfrog, E and B
synchronized at integer steps):

  1. halo-pad the fields at t^n and cut the per-tile windows;
  2. per species, the advance (ops/advance.py): gather E^n, B^n -> Boris
     u^{n-1/2} -> u^{n+1/2} -> move x^n -> x^{n+1} (stored wrapped on a
     periodic deck, unwrapped between absorbing walls) -> Esirkepov
     J^{n+1/2} tile windows, and each tile's max displacement;
  3. fold the J windows into the global J;
  4. B^n -> B^{n+1/2} -> E^{n+1} (with J) -> B^{n+1}, then, between
     absorbing walls, the damping mask (``fields/boundary.py``);
  5. between absorbing walls, kill (w = 0) and clamp every particle that
     left the grid (``binning.wrap_positions``);
  6. re-bin when the drift trigger or the interval schedule fires, or the
     window shifts: ``binning.rebin_auto`` for ``rebin_mode`` "auto" and
     "incremental" on both devices (the split, then the deal route where
     the buckets hold eight segment runs + 256 slots, else the sort route
     of the movers and append_incoming; the defrag when headroom is
     short), the full sort (``binning.rebin``) for "sort" or a deck whose
     buckets are too small for a mover buffer;
  7. moving window (``deck.moving_window``): when the light front has
     crossed the next tile column (``window_shift_now``), ``shift_window``
     rolls the fields one tile column left (the leading columns zeroed),
     rolls every species' buckets one tile column with x -= tile_nx, puts
     fresh plasma (``species.inject_column``) in the last tile column, and
     advances window_x0 by tile_nx.

A fields-only deck (no species) runs steps 4 and 7 alone.

Host syncs: the re-bin decision (``Schedule``, shared with the mesh
simulations) is taken on the host.  On the drift trigger each step reads
one device scalar, the drift predicate.  The interval schedule and the
window's schedule take the step counter and window_x0 from host copies
of the state the step returned (a state it did not make is read once,
``_HostClock``); under the interval's grace a step the interval does not
fire reads the backlog flag.  The re-bin itself reads nothing back: its
force flag, its append-or-defrag choice and the drift reset stay on the
device.  ``Driver.run_step`` adds one read on each step that re-binned
(its overflow, zero on every other step) and the census every
``CAPACITY_CHECK_EVERY`` steps.

Spans (``trace.span``; profiler ranges while a profiler runs) name the
step's layers: ``minipic.fields`` (pad, window extract, J fold, Yee,
damping, the window's field roll), ``minipic.advance`` (the kernel and its
epilogue), ``minipic.rebin`` (with the kill at the walls and the window's
bucket roll and injection) and ``minipic.diag`` (energies, momentum, live
count, weight guard).  Inside them, with the recorder on (``trace``), the
sub-spans ``fields.tiles``, ``fields.fold``, ``fields.b_half``,
``fields.e_full``, ``fields.damping``, ``rebin.kill``, ``rebin.sort`` and
those of ``binning.rebin_auto``; around them ``step`` (each step), and
``step.census`` and ``step.read`` in ``Driver.run_step``.  Every host
read of the step goes through ``trace.read``, which counts it by site.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .core.config import Deck
from .core.state import (
    CurrentState,
    FieldState,
    ParticleState,
    SimState,
)
from .fields.boundary import apply_damping, damping_mask
from .fields.halo import fold_block_periodic, pad_fields_periodic
from .fields.tiles import extract_field_tiles, fold_tiles
from .fields.yee import update_b_half_periodic, update_e_full_periodic
from .ops.advance import fused_push_deposit, resolve_mode
from .ops.diag import census, moments
from .particles import species as species_mod
from .particles.binning import rebin, rebin_auto, wrap_positions
from .particles.species import load_species, mix_seed
from .trace import read, span

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
    weight_nonuniform: torch.Tensor  # int32: checked species, uneven w
    rebinned: bool  # host: this step re-binned (overflow is 0 otherwise)


def weight_checks(deck: Deck) -> Tuple[bool, ...]:
    """Per species, whether the step's census counts it when its LIVE
    weights are not uniform (``StepDiag.weight_nonuniform``): the int8
    deposit scales jx/jy by q*max(w), right only for uniform w, so a
    species the int8 deposit takes by its uniform weights is checked."""
    return tuple(deck.deposit == "int8" and spec.uniform_weights()
                 for spec in deck.species)


def tile_origins(tiling, device, row0: int = 0, col0: int = 0,
                 tile_rows: Optional[int] = None,
                 tile_cols: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ox, oy) int32 [T]: the global cell coordinates of each tile's origin
    for a row-major block of tile_rows x tile_cols tiles (the whole grid by
    default) whose first tile is (row0, col0) of the global tile grid."""
    rows = tiling.tile_rows if tile_rows is None else tile_rows
    cols = tiling.tile_cols if tile_cols is None else tile_cols
    t = torch.arange(rows * cols, device=device, dtype=torch.int32)
    ox = (col0 + t % cols) * tiling.tile_nx
    oy = (row0 + t // cols) * tiling.tile_ny
    return ox, oy


def tile_local_coords(x, y, origins, tile_nx: int, tile_ny: int,
                      grid: Optional[Tuple[int, int]] = None):
    """Bucket-tile-local coordinates, with nearest-image centering on a
    periodic `grid` (raw offsets for grid None); `origins` as
    ``tile_origins`` gives them.

    The fold is a reciprocal multiply, not a division — the same f32 ops as
    the advance's fold, so diagnostics (rho for continuity) evaluate shapes
    at the coordinates the deposit used; the int8 deposit's exactness
    check depends on it."""
    ox, oy = (o.to(x.dtype)[:, None] for o in origins)
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


def window_shift_now(step, window_x0, dt: float, tile_nx: int, dx: float):
    """Moving-window shift predicate, in float32 as the JAX package's
    (``minipic_tpu/simulation.py:127-145``) so that both shift on the same
    steps: shift when the light front at t = (step + 1) dt has crossed the
    next tile-column boundary beyond the window_x0 // tile_nx shifts taken.
    Anchored on window_x0, a shift that f32 rounding delays is taken on the
    next step.  Host numpy: `step` and `window_x0` are ints or integer
    arrays; returns a numpy bool (array)."""
    period = np.float32(tile_nx * dx)
    done = (np.asarray(window_x0) // tile_nx).astype(np.float32)
    t1 = ((np.asarray(step).astype(np.float32) + np.float32(1.0))
          * np.float32(dt))
    return t1 >= (done + np.float32(1.0)) * period


def window_injection_key(species_index: int, w0n: int) -> int:
    """Seed of the plasma injected for species `species_index` when the
    window's origin reaches `w0n` cells: deterministic in (species,
    absolute column) alone, so a restart injects the same plasma
    (``species.inject_column`` seeds each global tile row from it)."""
    return mix_seed(0x77, species_index, w0n)


def shift_window(deck: Deck, state: SimState, w0n: int) -> SimState:
    """One window shift to origin `w0n` (= window_x0 + tile_nx): the fields
    roll tile_nx columns left with the leading columns zeroed; each
    species' buckets roll one tile column left with x -= tile_nx (the
    trailing column outflows); the last tile column takes
    ``species.inject_column``'s plasma, looked up by name at each call."""
    tiling = deck.tiling
    shift_c = tiling.tile_nx
    f = state.fields
    keep = torch.arange(deck.nx, device=f.ex.device) < deck.nx - shift_c
    with span("minipic.fields"):
        f = FieldState(*(torch.where(keep, torch.roll(c, -shift_c, dims=1),
                                     torch.zeros_like(c)) for c in f))
    out = []
    with span("minipic.rebin"):
        for i, (spec, p) in enumerate(zip(deck.species, state.species)):
            inj = species_mod.inject_column(
                spec, deck.domain, tiling, p.capacity,
                window_injection_key(i, w0n), w0n, deck.dtype, p.x.device)
            chans = []
            for name in ParticleState._fields:
                a = getattr(p, name).reshape(tiling.tile_rows,
                                             tiling.tile_cols, -1)
                a = torch.roll(a, -1, dims=1)
                if name == "x":
                    a = a - shift_c
                a[:, -1, :] = getattr(inj, name)
                chans.append(a.reshape(p.num_tiles, p.capacity))
            out.append(ParticleState(*chans))
    return state._replace(fields=f, species=tuple(out),
                          window_x0=state.window_x0 + shift_c)


class _HostClock:
    """Host copies of the step counter and window_x0 (None without a
    window) of the last state the step returned, so that the window's and
    the interval schedule's decisions cost no device read; a state the
    step did not make (other tensors) is read once."""

    def __init__(self):
        self._last = None

    def read(self, state: SimState) -> Tuple[int, Optional[int]]:
        last = self._last
        if (last is not None and last[0] is state.step
                and last[1] is state.window_x0):
            return last[2], last[3]
        w0 = state.window_x0
        return (read(state.step, "clock"),
                None if w0 is None else read(w0, "clock"))

    def keep(self, state: SimState, step: int, w0: Optional[int]) -> None:
        self._last = (state.step, state.window_x0, step, w0)


class Schedule:
    """The re-bin decision of a step, one for every simulation: the drift
    trigger (the largest displacement added to the drift, its predicate
    read once), or the interval schedule on the host's step count with
    its one-step grace; a window shift forces a re-bin."""

    def __init__(self, deck: Deck):
        self.deck = deck
        self.trigger_drift = bool(deck.species) and deck.uses_drift_trigger()
        # Interval schedule: when the guard affords one extra CFL step, a
        # mover-buffer overflow defers the tile to the next step instead
        # of dropping at once (the drift trigger's deferral budget).
        self.interval_grace = uses_rebin_auto(deck) and (
            (deck.rebin_interval + 1) * deck.cfl_step_cells()
            <= deck.guard - deck.shape_reach())

    def decide(self, step: Optional[int], drift: Optional[torch.Tensor],
               disp: Optional[torch.Tensor], shift_now: bool):
        """(re-bin now, force: bool or 0-d bool tensor, drift now) from the
        host step count (read on the interval schedule only), the drift
        carried in and the step's largest displacement."""
        deck = self.deck
        if not deck.species:
            return False, True, drift
        if self.trigger_drift:
            if drift is None:
                raise ValueError("deck uses drift-triggered re-binning but "
                                 "SimState.drift is unset")
            drift_now = drift + disp
            # A shift rolls buckets: no mover may wait in a trailing-column
            # bucket, so a shift step re-bins with force.
            do = shift_now or read(drift_now > deck.drift_threshold(),
                                   "drift")
            # Past this line a deferred re-bin may no longer wait: extract
            # with counted drops.  Stays on the device.
            force = True if shift_now else drift_now > deck.force_threshold()
            return do, force, drift_now
        sched = step % deck.rebin_interval == 0
        if self.interval_grace and not shift_now:
            # The backlog marker rides the drift (0 clean, 1 pending):
            # re-bin again next step, then drop and count.
            force = drift > 0.5
            return (deck.rebin_interval == 1 or sched
                    or read(force, "schedule")), force, drift
        return shift_now or deck.rebin_interval == 1 or sched, True, drift

    def after(self, do_rebin: bool, drift_now: torch.Tensor,
              pending_total: torch.Tensor) -> torch.Tensor:
        """The drift carried to the next step: reset only after a complete
        re-bin, as a backlog keeps it hot so the next step re-triggers and
        drains it."""
        if do_rebin and self.trigger_drift:
            return torch.where(pending_total == 0,
                               torch.zeros_like(drift_now), drift_now)
        if do_rebin and self.interval_grace:
            return (pending_total > 0).to(torch.float32)
        return drift_now


def resolve_backend(device: torch.device) -> str:
    """"cuda" (the kernels) for a CUDA device, "plain" on the CPU, whatever
    the deck's precision (``deposit_modes``: an f64 deck takes the
    advance's f64 mode)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not "
                               "available")
        return "cuda"
    if device.type == "cpu":
        return "plain"
    raise NotImplementedError(f"device {device}")


def advance_species_tiles(p: ParticleState, ftiles: FieldState, *, qm: float,
                          q: float, order: int, tile_ny: int, tile_nx: int,
                          origins: Tuple[torch.Tensor, torch.Tensor], g: int,
                          dt: float, dx: float, dy: float,
                          grid: Optional[Tuple[int, int]], mode: str):
    """Gather + push + move + deposit for one species over its buckets,
    tile t's origin at (origins[0][t], origins[1][t]) global cells.
    Returns (pushed particles, positions wrapped on a periodic `grid` and
    unwrapped for grid None, (jx, jy, jz) tile windows, max displacement in
    cells)."""
    return fused_push_deposit(
        p, ftiles, qm=qm, q=q, order=order, tile_ny=tile_ny,
        tile_nx=tile_nx, origins=origins, g=g, dt=dt, dx=dx, dy=dy,
        grid=grid, mode=mode)


def deposit_modes(deck: Deck) -> list:
    """Each species' deposit mode ("int8", "f32" or, for a float64 deck,
    "f64": ``resolve_mode``)."""
    modes = []
    for spec in deck.species:
        qw0 = (spec.charge * deck.dx * deck.dy / spec.ppc
               if spec.uniform_weights() else 0.0)
        modes.append(resolve_mode(deck.deposit, qw0, deck.tile_ny,
                                  deck.tile_nx, deck.guard, deck.dtype))
        if modes[-1] != "int8" and deck.gather_precision != "exact":
            raise NotImplementedError(
                f"gather_precision={deck.gather_precision!r} with the "
                f"{modes[-1]} deposit (the port gathers exactly)")
    return modes


def build_step(deck: Deck, device: torch.device):
    """Step function SimState -> (SimState, StepDiag) for `device`."""
    deck.validate()
    resolve_backend(device)
    tiling = deck.tiling
    g = deck.guard
    dt, dx, dy = deck.dt, deck.dx, deck.dy
    periodic = deck.boundary == "periodic"
    # The advance folds and wraps on a periodic box; between absorbing
    # walls it stores the raw move and the kill-and-clamp follows it.
    grid = (deck.nx, deck.ny) if periodic else None
    mask = (None if periodic else
            damping_mask(deck.ny, deck.nx, deck.absorb_width,
                         dtype=deck.dtype, device=device))
    sched = Schedule(deck)
    clock = (_HostClock() if deck.moving_window
             or (deck.species and not sched.trigger_drift) else None)
    origins = tile_origins(tiling, device)
    modes = deposit_modes(deck)
    checks = weight_checks(deck)
    n_sp = len(deck.species)

    def to_global(t):
        tr = t.reshape(tiling.tile_rows, tiling.tile_cols,
                       tiling.tile_ny + 2 * g, tiling.tile_nx + 2 * g)
        return fold_block_periodic(
            fold_tiles(tr, tiling.tile_ny, tiling.tile_nx, g), g)

    def step(state: SimState) -> Tuple[SimState, StepDiag]:
        f = state.fields
        dev = f.ex.device
        shift_now = False
        n_step = None
        if clock is not None:
            if deck.moving_window and state.window_x0 is None:
                raise ValueError("deck.moving_window but SimState.window_x0 "
                                 "is unset (Simulation sets it to 0)")
            n_step, w0 = clock.read(state)
            shift_now = deck.moving_window and bool(window_shift_now(
                n_step, w0, dt, tiling.tile_nx, dx))

        pushed, disps = [], []
        # The moments kernel writes each species' row in place.
        kes = torch.empty(n_sp, dtype=torch.float64, device=dev)
        moms = torch.empty((n_sp, 3), dtype=torch.float64, device=dev)
        jsum = None
        if deck.species:
            with span("minipic.fields"), span("fields.tiles"):
                ftiles = extract_field_tiles(
                    pad_fields_periodic(f, g), tiling.tile_rows,
                    tiling.tile_cols, tiling.tile_ny, tiling.tile_nx, g)
        for i, (spec, mode, p) in enumerate(zip(deck.species, modes,
                                                state.species)):
            with span("minipic.advance"):
                pnew, js, disp = advance_species_tiles(
                    p, ftiles, qm=spec.charge / spec.mass, q=spec.charge,
                    order=spec.shape_order, tile_ny=tiling.tile_ny,
                    tile_nx=tiling.tile_nx, origins=origins, g=g, dt=dt,
                    dx=dx, dy=dy, grid=grid, mode=mode)
            jsum = js if jsum is None else tuple(
                a + b for a, b in zip(jsum, js))
            pushed.append(pnew)
            disps.append(disp)
            with span("minipic.diag"):
                moments(pnew, spec.mass, (kes[i], moms[i]))

        with span("minipic.fields"):
            with span("fields.fold"):
                j = None if jsum is None else CurrentState(*(to_global(t)
                                                             for t in jsum))
            with span("fields.b_half"):
                f = update_b_half_periodic(f, dt, dx, dy)
            with span("fields.e_full"):
                f = update_e_full_periodic(f, dt, dx, dy, j)
            with span("fields.b_half"):
                f = update_b_half_periodic(f, dt, dx, dy)
            if mask is not None:
                with span("fields.damping"):
                    f = apply_damping(f, mask)

        disp = None
        if sched.trigger_drift:
            for d in disps:
                disp = d if disp is None else torch.maximum(disp, d)
        do_rebin, force, drift_now = sched.decide(n_step, state.drift, disp,
                                                  shift_now)

        overflow = torch.zeros((), dtype=torch.int32, device=dev)
        pending_total = torch.zeros((), dtype=torch.int32, device=dev)
        binned = []
        for p in pushed:
            with span("minipic.rebin"):
                if not periodic:
                    with span("rebin.kill"):
                        p = wrap_positions(p, deck.nx, deck.ny,
                                           periodic=False)
                if do_rebin:
                    mc, sc = rebin_caps(deck, p.capacity)
                    if mc > 0:
                        p, ov, pend = rebin_auto(p, tiling, mc, force=force,
                                                 seg_cap=sc)
                        pending_total = pending_total + pend
                    else:
                        with span("rebin.sort"):
                            p, ov = rebin(p, tiling)
                    overflow = overflow + ov
            binned.append(p)
        drift_now = sched.after(do_rebin, drift_now, pending_total)

        with span("minipic.diag"):
            c = census(binned, checks, f, dx, dy, dev)
            diag = StepDiag(
                field_energy=c.field_energy,
                kinetic_energy=kes,
                overflow=overflow,
                momentum=moms,
                shard_live=c.live,
                weight_nonuniform=c.nonuniform,
                rebinned=do_rebin,
            )
        new_state = SimState(fields=f, species=tuple(binned),
                             step=state.step + 1, drift=drift_now,
                             window_x0=state.window_x0)
        if clock is not None:
            if shift_now:
                w0 += tiling.tile_nx
                new_state = shift_window(deck, new_state, w0)
            clock.keep(new_state, n_step + 1, w0)
        return new_state, diag

    return step


class Driver:
    """What the single-device and the mesh simulations share: the seeded
    initial load, the step loop (``step``, ``run``, ``run_step``) with the
    capacity policy's managers (``_capmgrs``) and the counters, and
    ``force_rebin``.  The step function ``_step`` works on ``_st``, the
    state as the simulation holds it.  A subclass sets ``deck`` and
    ``device`` before ``_start`` and ``_step`` around it, and supplies the
    ``state`` view (get and set) and ``ensure_capacity``."""

    def _start(self, fields: Optional[FieldState], seed: int,
               perm: Optional[np.ndarray] = None) -> None:
        """The seeded load of every species on ``device`` (buckets put in
        storage order by `perm`, perm[storage row] = tile id), zero fields
        unless `fields` are given, step 0, no drift, window_x0 0 on a
        moving window; then ``state`` set to it."""
        deck, dev = self.deck, self.device
        cap = bucket_capacity(deck)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        rows = None if perm is None else torch.as_tensor(perm, device=dev)

        def load(spec):
            p = load_species(spec, deck.domain, deck.tiling, cap, gen,
                             deck.dtype, dev)
            return p if rows is None else ParticleState(
                *(a.index_select(0, rows) for a in p))

        species = tuple(load(spec) for spec in deck.species)
        if fields is None:
            fields = FieldState.zeros(deck.ny, deck.nx, deck.dtype, dev)
        self.state = SimState(
            fields=fields, species=species,
            step=torch.zeros((), dtype=torch.int32, device=dev),
            drift=torch.zeros((), dtype=torch.float32, device=dev),
            window_x0=(torch.zeros((), dtype=torch.int32, device=dev)
                       if deck.moving_window else None))
        self._capmgrs = None  # per-species CapacityManagers, built lazily
        self.capacity_changes = 0
        self.overflow_total = 0  # particles dropped over `run` calls

    def _managers(self) -> list:
        """The capacity policy's managers, one per species; ``_capmgrs =
        None`` restarts the policy."""
        from .parallel.balance import CapacityManager

        if self._capmgrs is None:
            self._capmgrs = [CapacityManager() for _ in self.deck.species]
        return self._capmgrs

    def step(self, n: int = 1) -> Optional[StepDiag]:
        diag = None
        for _ in range(n):
            with span("step"):
                self._st, diag = self._step(self._st)
        return diag

    def force_rebin(self) -> None:
        """Make the next step re-bin: the drift set to infinity fires the
        drift trigger, or, under the interval's grace, a forced pass."""
        self._st = self._st._replace(
            drift=torch.full_like(self._st.drift, float("inf")))

    def run(self, n_steps: Optional[int] = None,
            save_every: Optional[int] = None,
            saver: Optional[Callable] = None) -> Optional[StepDiag]:
        """Run the deck (``deck.total_steps`` by default) and call
        ``saver(state, step)`` at step 0 and every `save_every` steps
        (``deck.save_frequency`` by default).  The buckets grow on the first
        step that overflows and are checked every CAPACITY_CHECK_EVERY
        steps (``ensure_capacity``), as in the JAX package; only a step that
        re-binned can overflow, so only its overflow is read.  A deck with
        no species reads nothing.  ``overflow_total`` adds up what was
        dropped.  Returns the last StepDiag."""
        n_steps = self.deck.total_steps if n_steps is None else n_steps
        save_every = (self.deck.save_frequency if save_every is None
                      else save_every)
        if saver is not None:
            saver(self.state, 0)
        diag = None
        for i in range(1, n_steps + 1):
            diag = self.run_step(i)
            if saver is not None and i % save_every == 0:
                saver(self.state, i)
        return diag

    def run_step(self, i: int) -> StepDiag:
        """One step of ``run``, numbered `i`: step, read the overflow if the
        step re-binned (add it to ``overflow_total`` and grow the buckets
        at once), and check the capacity when `i` is a multiple of
        CAPACITY_CHECK_EVERY.  The CLI numbers its steps absolutely, so a
        resumed run checks on the steps an uninterrupted one does."""
        with span("step"):
            self._st, diag = self._step(self._st)
            ovf = read(diag.overflow, "overflow") if diag.rebinned else 0
            self.overflow_total += ovf
            if self.deck.species and (ovf > 0
                                      or i % CAPACITY_CHECK_EVERY == 0):
                with span("step.census"):
                    self.ensure_capacity(ovf)
        return diag


class Simulation(Driver):
    """User-facing entry point: holds a deck and a device, builds the initial
    state, owns the step.  The device is the card unless the caller asks
    for another (``device="cpu"`` runs the plain versions)."""

    def __init__(self, deck: Deck, fields: Optional[FieldState] = None,
                 seed: int = 0, *, device="cuda"):
        deck.validate()
        self.deck = deck
        self.device = torch.device(device)
        self.backend = resolve_backend(self.device)
        self._start(fields, seed)
        self._step = build_step(deck, self.device)

    @property
    def state(self) -> SimState:
        """The state the step works on (no copy)."""
        return self._st

    @state.setter
    def state(self, state: SimState) -> None:
        self._st = state

    def ensure_capacity(self, overflow: int = 0) -> bool:
        """Grow the buckets on overflow or high occupancy, shrink them after
        a calm spell (``parallel.balance.CapacityManager``, one per
        species), keeping the bucket quantum.  A shrink that the positional
        census does not fit yet is deferred.  Returns True if a capacity
        changed; the step takes the new shapes as they come."""
        from .parallel.balance import census, with_capacity

        changed = False
        species = list(self._st.species)
        for i, (p, mgr) in enumerate(zip(species, self._managers())):
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
            self._st = self._st._replace(species=tuple(species))
            self.capacity_changes += 1
        return changed
