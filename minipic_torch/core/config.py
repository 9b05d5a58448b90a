"""Declarative input deck (torch port of ``minipic_tpu.core.config``: the
same fields and derived quantities; only ``Deck.dtype`` is a torch dtype).

The reference configures runs by editing compile-time constants in ``main``
(``PIC_2D.cpp:36,57-74``) and re-compiling; the only machine-readable config
artifact is the exported ``params.txt`` (``PIC_2D.cpp:425-438``).  Here the
deck is a frozen dataclass tree: hashable, serializable to/from the same
``params.txt`` keys plus species sections, and the single source of truth
for every derived quantity (dx, dt, tile grid, mesh shape).

Units are the reference's normalized set: lengths in c/omega_p, time in
1/omega_p, fields in m_e c omega_p / e, charge/mass in e / m_e, density in
the reference density n0 (File_reader.py:140-142, report §4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from .geometry import Domain, Tiling, find_best_grid


@dataclasses.dataclass(frozen=True)
class SpeciesSpec:
    """One particle species.

    The reference's ``Particle`` struct (``Auxiliar_functions.h:16-21``)
    fixes the per-particle state contract {charge, x, y, px, py, pz}; the
    species-level fields here (ppc, density/drift profiles, shape order) are
    the loading parameters the reference left unimplemented.
    """

    name: str
    charge: float = -1.0  # units of e
    mass: float = 1.0  # units of m_e
    ppc: int = 16  # macroparticles per cell
    # density(x, y) -> n/n0; None means uniform density 1.
    density: Optional[Callable] = None
    # Drift momentum (m_e c) and isotropic thermal momentum spread.
    ux: float = 0.0
    uy: float = 0.0
    uz: float = 0.0
    uth: float = 0.0
    # Per-axis thermal spread overrides (anisotropic loads, e.g. Weibel).
    uth_x: Optional[float] = None
    uth_y: Optional[float] = None
    uth_z: Optional[float] = None
    # Particle shape order: 1 = linear (CIC), 2 = quadratic (TSC).
    shape_order: int = 1
    # How the density profile maps to macroparticles:
    #   "weight": uniform ppc everywhere, w = n dxdy/ppc (quiet, the
    #             default — noise-free gradients, uniform per-tile counts);
    #   "count":  uniform weight w = n_max dxdy/ppc, per-cell LIVE COUNT
    #             thinned to ~ppc * n/n_max (deterministic sub-lattice
    #             culling).  Counts now follow the profile — the loader for
    #             load-balance stress decks where per-chip work (~ live
    #             particles) must actually contrast.
    load_mode: str = "weight"
    # Profile ceiling for load_mode="count" (the thinning denominator and
    # the survivors' uniform weight): None derives max(n) over whatever
    # domain the loader evaluates — fine for a static box, WRONG for a
    # moving window (each injected column would renormalize against its
    # own local max).  Declare it for windowed count-mode decks;
    # Deck.validate enforces.
    n_max: Optional[float] = None

    def thermal_spread(self) -> Tuple[float, float, float]:
        return (
            self.uth if self.uth_x is None else self.uth_x,
            self.uth if self.uth_y is None else self.uth_y,
            self.uth if self.uth_z is None else self.uth_z,
        )

    def uniform_weights(self) -> bool:
        """True when every live macroparticle of this species carries the
        same weight BY CONSTRUCTION — the deck-time gate for the int8
        matched-quantization deposit (q*w must factor out of the
        contraction).  Uniform-density loads qualify; count-mode loads
        qualify only with a DECLARED n_max (survivor weight
        n_max*dxdy/ppc): without one the loader derives max(n) over
        whatever domain it evaluates, which is shard-local in sharded
        runs — per-shard 'uniform' values that differ across shards, the
        exact failure the runtime weight guard (weight_nonuniform)
        exists to catch."""
        if self.density is None:
            return True
        return self.load_mode == "count" and self.n_max is not None


@dataclasses.dataclass(frozen=True)
class Deck:
    """Full run description."""

    # --- domain & grid (reference PIC_2D.cpp:58-65) ---
    box_x: float = 10.0
    box_y: float = 10.0
    nx: int = 450
    ny: int = 450
    guard: int = 2  # halo width for comm + deposition support

    # --- tiling (reference: 36 tiles/rank of 25x25 cells, PIC_2D.cpp:36-38) ---
    tile_nx: int = 25
    tile_ny: int = 25

    # --- time stepping (reference PIC_2D.cpp:70-74) ---
    dt_factor: float = 0.5  # dt = dt_factor * dt_CFL
    sim_time: float = 500.0
    save_frequency: int = 25

    # --- physics ---
    species: Tuple[SpeciesSpec, ...] = ()
    boundary: str = "periodic"  # or "absorbing" (masked damping layer)
    absorb_width: int = 16  # damping layer width in cells (absorbing only)
    # Moving window (laser-plasma staging): the simulation frame follows
    # the pulse at c, advancing in TILE-COLUMN quanta — a window shift is
    # then a pure bucket roll (tile-local coordinates, and hence the
    # drift watermark and all shape windows, are untouched), the trailing
    # tile column outflows, and a freshly-loaded column enters at the
    # leading edge (particles/species.inject_column, keyed by the
    # absolute column so restarts are deterministic).  The reference has
    # no analogue; this is the capability its laser test case (report
    # §4) points toward.  Requires boundary="absorbing".
    moving_window: bool = False

    # --- numerics / machine mapping ---
    precision: str = "f32"  # "f32" | "f64"
    # Device mesh (rows, cols) of the multi-device simulations (parallel/); None
    # -> near-square over the devices given.
    mesh_shape: Optional[Tuple[int, int]] = None
    # Particle buffer capacity per tile; None -> auto from ppc with headroom.
    tile_capacity: Optional[int] = None
    capacity_headroom: float = 1.5
    # Re-bin particles into tiles every this many steps (guard cells bound
    # the allowed drift in between; see particles/binning.py).
    rebin_interval: int = 1
    # When to re-bin: "drift" re-bins only when the *measured* accumulated
    # particle drift (tracked on device each step) approaches the guard
    # slack — typically 5-20x less often than the light-speed-bound
    # interval schedule for thermal plasmas, at identical correctness
    # (the guard invariant is enforced against actual motion, not the
    # worst case).  "interval" is the fixed every-rebin_interval-steps
    # schedule; "auto" = drift.
    rebin_trigger: str = "auto"
    # Chunk of particle slots per block of the JAX package's advance (0 =
    # whole buckets).  The port's kernel takes a whole bucket per thread
    # block whatever the value; it sets the bucket alignment only
    # (simulation.Simulation).
    kchunk: int = 256
    # Field-gather precision of the JAX package: "exact", "f32x3", "fast"
    # (TPU matmul precisions) or "quant" (the int8 deposit's matched
    # shapes, selected with deposit="int8").  The port gathers exactly in
    # f32 mode and with the quantized shapes in int8 mode.
    gather_precision: str = "exact"
    # Deposit: "" or "highest" = f32 Esirkepov.  "int8" = matched-
    # quantization integer-ring Esirkepov (continuity exact against the
    # quantized rho; shapes rounded to 1/83rds (TSC) / 1/62nds (CIC) on
    # both the gather and deposit sides, so there is no self-force).  int8
    # needs uniform particle weights (density profiles fall back to f32);
    # the JAX package measured its 10k-step two-stream energy acceptance
    # on a TPU (docs/energy_tpu_10k_int8q.json).
    deposit: str = ""
    # Re-binning strategy: "sort" = a stable sort of every slot by tile;
    # "auto" and "incremental" = the deal route (split, segment, append or
    # defrag: particles/binning.rebin_auto) on every device.  The JAX
    # package's "auto" takes the deal route on its Pallas backend only and
    # sorts on XLA.
    rebin_mode: str = "auto"
    # Outgoing mover buffer slots per tile for the deal route; None derives
    # them from the deck's kinematics (mover_cap).
    mover_capacity: Optional[int] = None

    def shape_reach(self) -> float:
        """Half-width of the widest species' deposition support in cells
        (+<=1 cell of motion is accounted separately)."""
        max_order = max((s.shape_order for s in self.species), default=1)
        return 1.0 if max_order == 1 else 1.5

    def cfl_step_cells(self) -> float:
        """Worst-case per-step displacement in cells (light-speed bound)."""
        return self.dt / min(self.dx, self.dy)

    def drift_threshold(self) -> float:
        """Drift-triggered re-bin threshold (cells): re-bin once measured
        accumulated drift exceeds this.  Two CFL steps below the guard
        slack: one for the step after the trigger, one of grace so a
        re-bin deferred by mover-buffer pressure (rebin_auto's
        all-or-nothing extraction) can drain on the next step before the
        force-drop line (force_threshold) is reached."""
        return self.guard - self.shape_reach() - 2.0 * self.cfl_step_cells()

    def force_threshold(self) -> float:
        """Accumulated drift beyond which a deferred re-bin must extract
        even at the cost of counted drops: one more light-speed step would
        push a particle's shape support outside the guard band."""
        return self.guard - self.shape_reach() - self.cfl_step_cells()

    def uses_drift_trigger(self) -> bool:
        if self.rebin_trigger == "drift":
            return True
        if self.rebin_trigger == "auto":
            # Fall back to the interval schedule when the guard leaves no
            # measured-drift budget (e.g. minimal guard + wide shapes).
            return self.drift_threshold() > 0
        return False

    def expected_mover_fraction(self) -> float:
        """Fraction of a tile's particles expected to cross a tile boundary
        between re-bins.

        interval trigger: from the deck's own kinematics — per step a
        particle drifts |v| dt/dx cells, so over `rebin_interval` steps the
        escaping band is rebin*vx_bar*dt/dx cells of the tile_nx-wide tile
        (same in y).  v_bar per axis = |drift| + sqrt(2/pi) uth (half-
        normal mean), clamped to c.  Max over species (buffers are
        per-species but share one size).

        drift trigger: the trigger fires when the *fastest* particle's
        accumulated drift hits the threshold, but the escaping band is set
        by the *bulk* drift by then — threshold x (v_bulk / v_max), with
        v_max ~ |u| + 6 uth (the ~1e8-sample Gaussian extreme).  The hard
        bound (no particle beyond threshold+1 cells) caps it; mover-buffer
        overflow beyond the expectation falls back losslessly."""
        if self.uses_drift_trigger():
            band = self.drift_threshold() + self.dt / min(self.dx, self.dy)
            vmax = 0.0
            for s in self.species:
                tx, ty, _ = s.thermal_spread()
                vmax = max(vmax, min(1.0, abs(s.ux) + 6.0 * tx),
                           min(1.0, abs(s.uy) + 6.0 * ty))
            frac = 0.0
            for s in self.species:
                tx, ty, _ = s.thermal_spread()
                vxm = min(1.0, abs(s.ux) + 0.7979 * tx)
                vym = min(1.0, abs(s.uy) + 0.7979 * ty)
                ratio_x = vxm / vmax if vmax > 0 else 0.0
                ratio_y = vym / vmax if vmax > 0 else 0.0
                f = band * (min(1.0, ratio_x) / self.tile_nx
                            + min(1.0, ratio_y) / self.tile_ny)
                frac = max(frac, f)
            return frac
        frac = 0.0
        for s in self.species:
            tx, ty, _ = s.thermal_spread()
            vx = min(1.0, abs(s.ux) + 0.7979 * tx)
            vy = min(1.0, abs(s.uy) + 0.7979 * ty)
            f = self.rebin_interval * self.dt * (
                vx / (self.dx * self.tile_nx) + vy / (self.dy * self.tile_ny)
            )
            frac = max(frac, f)
        return frac

    def mover_cap(self, capacity: int) -> int:
        """Outgoing/incoming mover buffer slots per tile.  Auto mode derives
        the size from the deck's expected mover fraction instead of a
        hand-tuned knob.  Underestimate semantics (rebin_auto): an
        *outgoing* overflow defers the tile losslessly (all-or-nothing
        extraction; drained next step, forced with counted drops only past
        the hard drift line); an *incoming* overflow — arrivals from up to
        8 neighbors converging on one tile beyond this buffer — is dropped
        and counted in the overflow diag.  Size generously for strongly
        convergent flows (or set mover_capacity explicitly).
        Returns 0 when the bucket is too small for the incremental path."""
        room = ((capacity - 256) // 128) * 128
        if room < 128:
            return 0
        if self.mover_capacity is not None:
            return min(self.mover_capacity, room)
        # Crowding safety over the expected-band estimates (underestimates
        # defer losslessly to the next step, so this trades only time).
        # No artificial ceiling beyond `room`: clamping to the old
        # capacity//8 heuristic knowingly undersized drifting-beam decks
        # (expected_mover_fraction * safety > 1/8), turning every re-bin
        # into a deferral and, past the drift budget, counted drops.
        #
        # Drift-mode safety 1.3: the band estimate is itself a tail bound —
        # measured per-tile mover census on the bench deck (1e8 thermal
        # particles, 8^2 tiles, TSC): peak 1653 / mean 1481 at trigger vs
        # the formula's safety-free 1922 (already 1.16x the peak).  The
        # route sort cost scales linearly with this buffer (measured by the
        # JAX package on a TPU v5e: 325 ms at 4096 slots -> 127 ms at
        # 1536), so oversizing is the biggest re-bin tax; undersizing only
        # defers (outgoing) while incoming keeps a >1.4x margin over the
        # measured arrivals.
        safety = 1.3 if self.uses_drift_trigger() else 4.0
        derived = safety * self.expected_mover_fraction() * capacity
        base = max(512, -(-int(derived) // 128) * 128)
        return min(base, room)

    def mover_seg_cap(self, mover_cap: int, kc: int = 256) -> int:
        """Per-direction slot capacity of the deal-route segment buffer
        (rebin_kernels.segment_movers): the worst single direction's
        expected share of a tile's movers, from the same kinematics as
        expected_mover_fraction.  Directional crossing rates: v+ per axis
        is the mean positive-going speed (drift one-sided + half the
        half-normal thermal mass); a direction's share is its axis rate
        over the total.  Safety 1.6 (shares are rougher than totals, and
        segment overflow cannot defer — the movers are already out of
        their buckets — so it drops and counts).  Rounded up to the
        segment kernel's chunk (kc), clamped to [kc, mover_cap]."""
        rates = []
        for s in self.species:
            tx, ty, _ = s.thermal_spread()
            half = 0.3989  # E[v+] of a zero-mean half-normal, per uth
            rates.append((
                min(1.0, max(0.0, s.ux) + half * tx) / self.tile_nx,
                min(1.0, max(0.0, -s.ux) + half * tx) / self.tile_nx,
                min(1.0, max(0.0, s.uy) + half * ty) / self.tile_ny,
                min(1.0, max(0.0, -s.uy) + half * ty) / self.tile_ny,
            ))
        share = 0.25
        for r in rates:
            tot = sum(r)
            if tot > 0:
                share = max(share, max(r) / tot)
        derived = 1.6 * share * self.expected_mover_fraction() * (
            self.capacity()
        )
        base = max(kc, -(-int(derived) // kc) * kc)
        return min(base, max(kc, (mover_cap // kc) * kc))

    # Per-direction cross-shard particle exchange buffer capacity (slots);
    # None -> auto from the shard edge.  Only the shard-boundary tiles feed
    # these, so a fraction of one tile's capacity suffices.
    exchange_capacity: Optional[int] = None

    def exchange_cap(self, block_ny: int, block_nx: int) -> int:
        """Per-direction routing buffer size.  Worst case is bursty: a quiet-
        start lattice sends a whole boundary column/row of a shard across in
        one step — edge_cells * ppc particles simultaneously — so the buffer
        scales with the shard edge length, with 2x headroom."""
        if self.exchange_capacity is not None:
            return self.exchange_capacity
        ppc = max((s.ppc for s in self.species), default=1)
        burst = max(block_ny, block_nx) * ppc * 2
        return max(64, -(-burst // 8) * 8)

    # ------------------------------------------------------------------
    @property
    def dtype(self):
        return torch.float64 if self.precision == "f64" else torch.float32

    @property
    def domain(self) -> Domain:
        return Domain(self.box_x, self.box_y, self.nx, self.ny)

    @property
    def tiling(self) -> Tiling:
        return Tiling.for_domain(self.domain, self.tile_nx, self.tile_ny)

    @property
    def dx(self) -> float:
        return self.domain.dx

    @property
    def dy(self) -> float:
        return self.domain.dy

    @property
    def dt(self) -> float:
        return self.dt_factor * self.domain.dt_courant()

    @property
    def total_steps(self) -> int:
        return int(self.sim_time / self.dt)

    def capacity(self) -> int:
        """Particle slots per tile (static shape)."""
        if self.tile_capacity is not None:
            return self.tile_capacity
        ppc = max((s.ppc for s in self.species), default=0)
        nominal = ppc * self.tile_nx * self.tile_ny
        cap = int(math.ceil(nominal * self.capacity_headroom))
        return max(8, -(-cap // 8) * 8)  # round up to a sublane multiple

    def mesh_dims(self, n_devices: int) -> Tuple[int, int]:
        """(rows, cols) device grid; near-square like the reference's rank
        grid (Auxiliar_functions.cpp:16-22)."""
        if self.mesh_shape is not None:
            return self.mesh_shape
        return find_best_grid(n_devices)

    def validate(self) -> None:
        t = self.tiling  # raises on divisibility violation
        if 2 * self.guard > min(self.tile_nx, self.tile_ny):
            # fields/tiles.py window extract/fold requires guard strips from
            # adjacent tiles only (2*guard <= tile edge).
            raise ValueError(
                f"guard={self.guard} too large for tile "
                f"{self.tile_ny}x{self.tile_nx}: need 2*guard <= tile edge"
            )
        for s in self.species:
            support = s.shape_order + 2  # shape width + <=1 cell of motion
            if self.guard * 2 < support:
                raise ValueError(
                    f"guard={self.guard} too small for shape_order="
                    f"{s.shape_order} (deposition support {support})"
                )
        if self.dt_factor >= 1.0:
            raise ValueError("dt_factor must be < 1 (CFL)")
        if self.deposit == "int8":
            for s in self.species:
                # Worst-case per-cell int32 accumulation: 9 window cells
                # x ppc particles x |q0+q1|*|q1-q0| <= 126^2 each.  An
                # int32 OVERFLOW corrupts currents silently, so this is
                # an error, not a warning.  (The int32->f32 output
                # conversion rounds past 2^24 — benign: both sides of
                # the continuity check share it.)
                if s.ppc * 9 * 126 * 126 > (1 << 31):
                    raise ValueError(
                        f"deposit='int8': species {s.name!r} ppc={s.ppc} "
                        "can overflow the int32 deposit accumulator "
                        "(need ppc <= ~15000)"
                    )
        nyg = self.tile_ny + 2 * self.guard
        nxg = self.tile_nx + 2 * self.guard
        if self.deposit == "int8" and not (
            6 * nyg <= 128 and 2 * nxg <= 128 and nyg % 8 == 0
        ):
            import warnings

            # Mode resolution keeps the JAX package's window rule
            # (ops/advance.resolve_mode): outside it the int8 deposit
            # silently runs in f32, so say so.
            warnings.warn(
                f"deposit='int8' with window {nyg}x{nxg} (tile "
                f"{self.tile_ny}x{self.tile_nx} + guard {self.guard}): the "
                "int8 deposit needs 6*(tile_ny+2g) <= 128, 2*(tile_nx+2g) "
                "<= 128 and (tile_ny+2g) % 8 == 0; the f32 deposit runs",
                stacklevel=2,
            )
        if self.rebin_trigger not in ("auto", "drift", "interval"):
            raise ValueError(f"unknown rebin_trigger {self.rebin_trigger!r}")
        if self.moving_window and self.boundary != "absorbing":
            raise ValueError(
                "moving_window requires boundary='absorbing' (the window "
                "outflows at the trailing edge; periodic wrap would "
                "re-inject stale plasma)"
            )
        if self.moving_window:
            for s in self.species:
                if (s.load_mode == "count" and s.density is not None
                        and s.n_max is None):
                    raise ValueError(
                        f"species {s.name!r}: load_mode='count' under a "
                        "moving window needs an explicit n_max (each "
                        "injected column would otherwise renormalize "
                        "against its own local profile max)"
                    )
        if self.species and self.rebin_trigger == "drift":
            # Drift-triggered re-binning enforces the guard invariant
            # against *measured* motion; the deck only needs room for one
            # worst-case step beyond the threshold.  ("auto" falls back to
            # the interval schedule instead of erroring.)
            if self.drift_threshold() <= 0:
                raise ValueError(
                    f"guard={self.guard} leaves no drift budget for "
                    f"shape reach {self.shape_reach()} + one CFL step — "
                    "increase guard or use rebin_trigger='interval' with "
                    "rebin_interval=1"
                )
        elif self.species and not self.uses_drift_trigger() and self.rebin_interval > 1:
            # The interval bound applies only when the interval schedule is
            # actually in effect — an "auto" deck with drift budget runs the
            # drift trigger, where rebin_interval is ignored.
            # Between re-binning passes a particle may drift from its stale
            # tile; its full shape support must stay inside the guard band.
            max_drift = self.rebin_interval * self.dt / min(self.dx, self.dy)
            slack = self.guard - self.shape_reach()
            if max_drift > slack:
                raise ValueError(
                    f"rebin_interval={self.rebin_interval} allows {max_drift:.2f} "
                    f"cells of drift but guard={self.guard} only tolerates {slack}"
                )

    # ------------------------------------------------------------------
    # params.txt round trip — key set from reference PIC_2D.cpp:425-438,
    # consumed by the reference's File_reader.read_params (File_reader.py:15).
    def params_txt(self, mesh_cols: int = 1, mesh_rows: int = 1) -> str:
        lines = [
            f"box_x={self.box_x}",
            f"box_y={self.box_y}",
            f"nx_global={self.nx}",
            f"ny_global={self.ny}",
            f"guard={self.guard}",
            f"interior_nx={self.tile_nx}",
            f"interior_ny={self.tile_ny}",
            f"sim_time={self.sim_time}",
            f"dt={self.dt}",
            f"total_steps={self.total_steps}",
        ]
        return "\n".join(lines) + "\n"
