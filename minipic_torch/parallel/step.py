"""Block-sharded PIC step over an R x C mesh (torch port of
``minipic_tpu.parallel.step``).

Each shard owns a contiguous block of the tile grid and of the fields.
Per step, per shard (the JAX package's per-chip program, with its
``ppermute``s as ``mesh.shift``s):

  1. one 6-component halo exchange of the fields at t^n -> padded block;
  2. tile windows -> the advance (ops/advance.py) per species, with each
     tile's GLOBAL origin;
  3. J windows folded into the padded block, then ``fold_halo`` adds the
     guard rings into the neighbours;
  4. B half (block stencil) -> exchange B -> E full (+J) -> exchange E ->
     B half; between absorbing walls each shard's part of the damping mask;
  5. re-bin when the mesh-wide drift (a ``pmax``, read once on the host)
     passes the threshold: the split with the shard's tile offset, then the
     deal route (segment with global coordinates and
     ``exchange.roll_segments_sharded``) where the buckets hold eight runs
     plus 256 slots, else ``exchange.exchange_particles`` and the sort of
     the movers, then the appends or the defrag under a mesh-agreed flag;
     the full sort (``rebin_flat`` after the exchange) where the buckets
     have no mover buffer;
  6. moving window: the fields and the buckets shift one tile column left,
     each shard handing its first column to its left neighbour, the last
     column of the mesh taking fresh plasma keyed per global tile row.

Host reads, each through ``trace.read``: the re-bin decision
(``simulation.Schedule``) reads the drift predicate once a step (the JAX
package's ``pmax`` then one read), or, under the interval's grace, the
backlog flag on a step the interval does not fire; ``run_step``
(``simulation.Driver``) adds the overflow on a step that re-binned and the
census every ``CAPACITY_CHECK_EVERY`` steps.  The step counter and the
window's origin live on the host, so the window's shift predicate reads
nothing.

Spans: the layers of ``simulation.py`` (``minipic.fields``, ``.advance``,
``.rebin``, ``.diag``) and ``minipic.parallel`` around every hand-off
between devices (``mesh.move``); ``step`` around each step,
``step.census`` around ``run_step``'s census.

``ShardedSimulation.state`` assembles the global SimState in the JAX
package's storage order (shard-major buckets, ``shard_major_permutation``;
global fields) and splits one when set, so checkpoints, snapshots and the
bridge see what the JAX simulation's global arrays hold.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.config import Deck
from ..core.state import (CurrentState, FieldState, ParticleState, SimState,
                          field_energy)
from ..fields.boundary import local_damping_mask
from ..fields.tiles import extract_field_tiles, fold_tiles
from ..fields.yee import update_b_half_block, update_e_full_block
from ..ops.diag import census, moments
from ..ops.rebin import (append_incoming_, append_segments_, defrag_buckets_,
                         identity_neighbor_table, segment_movers,
                         split_buckets)
from ..particles import species as species_mod
from ..particles.binning import finish_rebin, rebin_flat, wrap_positions
from ..simulation import (Driver, Schedule, StepDiag, advance_species_tiles,
                          align_capacity, deposit_modes, rebin_caps,
                          resolve_backend, tile_origins, window_injection_key,
                          window_shift_now)
from ..trace import span
from .exchange import exchange_particles, roll_segments_sharded
from .halo import exchange_halo, fold_halo
from .mesh import (PARALLEL_RANGE, Mesh, local_tile_grid, make_mesh, move,
                   move_all, on, pall, pmax, psum, shard_shape, shift)


class ShardedState(NamedTuple):
    """The multi-device simulations' state: per shard its fields and its
    species' buckets; the step counter and the window's origin on the host
    (every shard agrees on them); the drift since the last re-bin, 0-d
    float32 on the mesh's first device."""

    fields: List[FieldState]
    species: List[tuple]
    step: int
    drift: torch.Tensor
    window_x0: Optional[int]


def weight_violations(deck: Deck, species_per_shard, mesh: Mesh
                      ) -> torch.Tensor:
    """The census's uniform-weight guard (``simulation.weight_checks``)
    over the whole mesh: a species' live weights are compared across every
    shard."""
    dev0 = mesh.devices[0]
    bad = torch.zeros((), dtype=torch.int32, device=dev0)
    if deck.deposit != "int8":
        return bad
    for i, spec in enumerate(deck.species):
        if not spec.uniform_weights():
            continue
        wmax = pmax([sp[i].w.max() for sp in species_per_shard], mesh)[0]
        wmin = -pmax([-torch.where(sp[i].w > 0, sp[i].w,
                                   torch.full_like(sp[i].w, float("inf"))
                                   ).min()
                      for sp in species_per_shard], mesh)[0]
        bad = bad + ((wmin != wmax) & torch.isfinite(wmin)).to(torch.int32)
    return bad


def rebin_species(deck: Deck, mesh: Mesh, pushed, do_rebin: bool,
                  rebin: Callable):
    """Per species: between absorbing walls the kill and clamp
    (``wrap_positions``), then on a re-bin step ``rebin(ps, mover buffer,
    run)`` over the shards' buckets, which returns (buckets, dropped,
    pending) per shard.  Returns (buckets per shard, overflow, pending),
    the two sums on the mesh's first device."""
    dev0 = mesh.devices[0]
    overflow = torch.zeros((), dtype=torch.int32, device=dev0)
    pending = torch.zeros((), dtype=torch.int32, device=dev0)
    binned = [[] for _ in range(mesh.size)]
    for i in range(len(deck.species)):
        ps = []
        for s, dev in enumerate(mesh.devices):
            p = pushed[s][i]
            if deck.boundary != "periodic":
                with on(dev):
                    p = wrap_positions(p, deck.nx, deck.ny, periodic=False)
            ps.append(p)
        if do_rebin:
            ps, ovs, pends = rebin(ps, *rebin_caps(deck, ps[0].capacity))
            overflow = overflow + psum(ovs, mesh)[0]
            pending = pending + psum(pends, mesh)[0]
        for s, p in enumerate(ps):
            binned[s].append(p)
    return binned, overflow, pending


def mesh_diag(deck: Deck, mesh: Mesh, fe: torch.Tensor, kes, moms,
              overflow: torch.Tensor, binned, rebinned: bool) -> StepDiag:
    """The step's StepDiag on the mesh's first device: kinetic energies and
    momenta summed over the shards, one live count per shard."""
    dev0 = mesh.devices[0]
    live = []
    for dev, sp in zip(mesh.devices, binned):
        with on(dev):
            live.append(census(sp, device=dev).live.reshape(()))
    live = move_all(live, dev0)
    n_sp = len(deck.species)
    return StepDiag(
        field_energy=fe,
        kinetic_energy=(torch.stack([psum([k[i] for k in kes], mesh)[0]
                                     for i in range(n_sp)]) if n_sp
                        else torch.zeros(0, dtype=torch.float64,
                                         device=dev0)),
        overflow=overflow,
        momentum=(torch.stack([psum([m[i] for m in moms], mesh)[0]
                               for i in range(n_sp)]) if n_sp
                  else torch.zeros((0, 3), dtype=torch.float64,
                                   device=dev0)),
        shard_live=torch.stack(live),
        weight_nonuniform=weight_violations(deck, binned, mesh),
        rebinned=rebinned,
    )


def advance_shards(deck: Deck, mesh: Mesh, modes, species, ftiles, origins,
                   grid):
    """Every shard's species through the advance, each shard with its field
    windows and tile origins.  Returns, per shard, the pushed species and
    the J windows summed over them, its kinetic energies and momenta, and
    its largest displacement."""
    t = deck.tiling
    pushed, jwin, kes, moms, disps = [], [], [], [], []
    for s, dev in enumerate(mesh.devices):
        js_sum, ps, ke, mom, dsp = None, [], [], [], None
        with on(dev):
            for spec, mode, p in zip(deck.species, modes, species[s]):
                pnew, js, disp = advance_species_tiles(
                    p, ftiles[s], qm=spec.charge / spec.mass, q=spec.charge,
                    order=spec.shape_order, tile_ny=t.tile_ny,
                    tile_nx=t.tile_nx, origins=origins[s], g=deck.guard,
                    dt=deck.dt, dx=deck.dx, dy=deck.dy, grid=grid,
                    mode=mode)
                js_sum = js if js_sum is None else tuple(
                    a + b for a, b in zip(js_sum, js))
                ps.append(pnew)
                dsp = disp if dsp is None else torch.maximum(dsp, disp)
                k, m = moments(pnew, spec.mass)
                ke.append(k)
                mom.append(m)
        pushed.append(ps)
        jwin.append(js_sum)
        kes.append(ke)
        moms.append(mom)
        disps.append(dsp)
    return pushed, jwin, kes, moms, disps


def flag_on(v, dev):
    """A re-bin's force flag (a bool, or a 0-d tensor moved to `dev`)."""
    return move_all([v], dev)[0] if isinstance(v, torch.Tensor) else v


def build_sharded_step(deck: Deck, mesh: Mesh) -> Callable:
    """Step function ShardedState -> (ShardedState, StepDiag) over `mesh`."""
    deck.validate()
    for d in mesh.distinct():
        resolve_backend(d)
    rows, cols = mesh.shape
    S = mesh.size
    g = deck.guard
    dt, dx, dy = deck.dt, deck.dx, deck.dy
    tiling = deck.tiling
    nyt, nxt = tiling.tile_ny, tiling.tile_nx
    ltr, ltc = local_tile_grid(deck, mesh)
    ny_l, nx_l = shard_shape(deck, mesh)
    t_local = ltr * ltc
    periodic = deck.boundary == "periodic"
    grid = (deck.nx, deck.ny) if periodic else None
    xcap = deck.exchange_cap(ny_l, nx_l)
    if deck.species and S > 1:
        # Routing reaches mesh neighbours only (one hop per re-bin): the
        # drift between re-bins must stay within one shard block.
        if deck.uses_drift_trigger():
            max_drift = deck.force_threshold() + deck.cfl_step_cells()
        else:
            max_drift = deck.rebin_interval * deck.dt / min(deck.dx, deck.dy)
        if max_drift > min(nx_l, ny_l):
            raise ValueError(
                f"re-bin schedule allows {max_drift:.1f} cells of drift but "
                f"the shard block is only {ny_l}x{nx_l} — particles could "
                "skip a shard")
    sched = Schedule(deck)
    modes = deposit_modes(deck)
    dev0 = mesh.devices[0]

    shards = []
    for s, dev in enumerate(mesh.devices):
        r, c = mesh.coords(s)
        shards.append(dict(
            dev=dev, r=r, c=c, trow0=r * ltr, tcol0=c * ltc,
            origins=tile_origins(tiling, dev, r * ltr, c * ltc, ltr, ltc),
            mask=(None if periodic else local_damping_mask(
                r * ny_l, c * nx_l, ny_l, nx_l, deck.ny, deck.nx,
                deck.absorb_width, dtype=deck.dtype, device=dev)),
            ident=identity_neighbor_table(t_local, dev)))

    def exchange(blocks):
        return exchange_halo(blocks, g, mesh)

    def rebin_sort(ps):
        merged, dropped = exchange_particles(ps, mesh, block_nx=nx_l,
                                             block_ny=ny_l, cap=xcap)
        out, ovs, pends = [], [], []
        for sh, m, dr, p in zip(shards, merged, dropped, ps):
            with on(sh["dev"]):
                q, ov = rebin_flat(m, tile_rows=ltr, tile_cols=ltc,
                                   tile_nx=nxt, tile_ny=nyt,
                                   capacity=p.capacity, row0=sh["trow0"],
                                   col0=sh["tcol0"])
            out.append(q)
            ovs.append(ov + dr)
            pends.append(torch.zeros((), dtype=torch.int32,
                                     device=sh["dev"]))
        return out, ovs, pends

    def rebin_incremental(ps, force, mc, sc):
        """The sharded split / deal-route or small-sort / append-or-defrag
        pass (the JAX package's do_rebin_incremental)."""
        cap = ps[0].capacity
        use_seg = sc > 0 and cap >= 8 * sc + 256
        splits = []
        for sh, p in zip(shards, ps):
            with on(sh["dev"]):
                splits.append(split_buckets(
                    p, tile_cols=ltc, tile_ny=nyt, tile_nx=nxt, b_cap=mc,
                    force=flag_on(force, sh["dev"]), row0=sh["trow0"],
                    col0=sh["tcol0"]))
        if use_seg:
            segs, route_drop = [], []
            for sh, (_, movers, _, _) in zip(shards, splits):
                with on(sh["dev"]):
                    seg, sd = segment_movers(
                        movers, tile_rows=ltr, tile_cols=ltc, tile_ny=nyt,
                        tile_nx=nxt, b_seg=sc, row0=sh["trow0"],
                        col0=sh["tcol0"], grid_rows=tiling.tile_rows,
                        grid_cols=tiling.tile_cols)
                segs.append(seg)
                route_drop.append(sd.sum())
            incoming = roll_segments_sharded(segs, mesh, ltr=ltr, ltc=ltc,
                                             b_seg=sc)
        else:
            merged, x_drop = exchange_particles(
                [m for _, m, _, _ in splits], mesh, block_nx=nx_l,
                block_ny=ny_l, cap=xcap)
            incoming, route_drop = [], []
            for sh, m, xd in zip(shards, merged, x_drop):
                with on(sh["dev"]):
                    inc, ov = rebin_flat(m, tile_rows=ltr, tile_cols=ltc,
                                         tile_nx=nxt, tile_ny=nyt,
                                         capacity=mc, row0=sh["trow0"],
                                         col0=sh["tcol0"])
                incoming.append(inc)
                route_drop.append(ov + xd)
        oks = []
        for sh, (_, _, wm, _), inc in zip(shards, splits, incoming):
            with on(sh["dev"]):
                n_in = (inc.w > 0).sum(1, dtype=torch.int32)
                oks.append((wm + n_in <= cap - 256).all())
        ok = pall(oks, mesh)  # every shard takes the same branch
        out, ovs, pends = [], [], []
        for sh, (p1, _, wm, pending), inc, rd, okk in zip(
                shards, splits, incoming, route_drop, ok):
            with on(sh["dev"]):
                if use_seg:
                    app = append_segments_(p1, inc, wm, sh["ident"],
                                           b_seg=sc, active=okk)
                    _, dd = defrag_buckets_(p1, inc, sh["ident"], b_seg=sc,
                                            active=~okk)
                else:
                    app = append_incoming_(p1, inc, wm, active=okk)
                    _, dd = defrag_buckets_(p1, inc, active=~okk)
                dropped = (rd + app.sum() + dd.sum()).to(torch.int32)
                dropped, pend = finish_rebin(dropped, pending,
                                             flag_on(force, sh["dev"]))
            out.append(p1)
            ovs.append(dropped)
            pends.append(pend)
        return out, ovs, pends

    def shift_window(fields, species, w0n):
        """One window shift to origin w0n (see the module docstring)."""
        with span(PARALLEL_RANGE):
            strips = shift([torch.stack(tuple(f))[:, :, :nxt]
                            for f in fields], mesh, "rx", up=True)
        new_fields = []
        for sh, f, st in zip(shards, fields, strips):
            with on(sh["dev"]):
                if sh["c"] == cols - 1:
                    st = torch.zeros_like(st)
                stk = torch.stack(tuple(f))
                new_fields.append(FieldState(
                    *torch.cat([stk[:, :, nxt:], st], dim=2).unbind(0)))
        new_species = [[] for _ in range(S)]
        for i, spec in enumerate(deck.species):
            with span(PARALLEL_RANGE):
                firsts = shift([torch.stack([a.reshape(ltr, ltc, -1)[:, 0]
                                             for a in sp[i]])
                                for sp in species], mesh, "rx", up=True)
            for s, (sh, sp, rc) in enumerate(zip(shards, species, firsts)):
                p = sp[i]
                with on(sh["dev"]):
                    if sh["c"] == cols - 1:
                        inj = species_mod.inject_column(
                            spec, deck.domain, tiling, p.capacity,
                            window_injection_key(i, w0n), w0n, deck.dtype,
                            sh["dev"], row_ids=range(sh["trow0"],
                                                     sh["trow0"] + ltr))
                        last = torch.stack(tuple(inj))
                    else:
                        last = rc.clone()
                        last[0] -= nxt
                    chans = []
                    for ci, a in enumerate(p):
                        a = torch.roll(a.reshape(ltr, ltc, -1), -1, dims=1)
                        if ci == 0:
                            a = a - nxt
                        a[:, -1, :] = last[ci]
                        chans.append(a.reshape(t_local, p.capacity))
                new_species[s].append(ParticleState(*chans))
        return new_fields, [tuple(sp) for sp in new_species]

    def fields_update(fpads, jwin):
        """J folded, then the block Yee with an exchange after each phase
        and the walls' damping: (new fields, field energies) per shard."""
        j = [None] * S
        if deck.species:
            jpads = []
            for sh, js in zip(shards, jwin):
                with on(sh["dev"]):
                    jpads.append(torch.stack([
                        fold_tiles(t.reshape(ltr, ltc, nyt + 2 * g,
                                             nxt + 2 * g), nyt, nxt, g)
                        for t in js]))
            j = [CurrentState(*b.unbind(0)) for b in fold_halo(jpads, g,
                                                              mesh)]
        fp = []
        for sh, f in zip(shards, fpads):
            with on(sh["dev"]):
                fp.append(update_b_half_block(f, g, dt, dx, dy))
        bpad = exchange([torch.stack([f.bx, f.by, f.bz])[:, g:-g, g:-g]
                         for f in fp])
        for s, sh in enumerate(shards):
            with on(sh["dev"]):
                f = FieldState(fp[s].ex, fp[s].ey, fp[s].ez,
                               *bpad[s].unbind(0))
                fp[s] = update_e_full_block(f, g, dt, dx, dy, j[s])
        epad = exchange([torch.stack([f.ex, f.ey, f.ez])[:, g:-g, g:-g]
                         for f in fp])
        fnew, fes = [], []
        for s, sh in enumerate(shards):
            with on(sh["dev"]):
                f = FieldState(*epad[s].unbind(0), fp[s].bx, fp[s].by,
                               fp[s].bz)
                f = update_b_half_block(f, g, dt, dx, dy)
                f = FieldState(*(c[g:-g, g:-g] for c in f))
                if sh["mask"] is not None:
                    f = FieldState(*(c * sh["mask"] for c in f))
                fnew.append(f)
                fes.append(field_energy(f, dx, dy))
        return fnew, fes

    def step(st: ShardedState) -> Tuple[ShardedState, StepDiag]:
        shift_now = False
        if deck.moving_window:
            if st.window_x0 is None:
                raise ValueError("deck.moving_window but the window origin "
                                 "is unset (ShardedSimulation sets it)")
            shift_now = bool(window_shift_now(st.step, st.window_x0, dt,
                                              nxt, dx))
        with span("minipic.fields"):
            fpads = [FieldState(*p.unbind(0)) for p in
                     exchange([torch.stack(tuple(f)) for f in st.fields])]
        with span("minipic.advance"):
            ftiles = []
            for sh, f in zip(shards, fpads if deck.species else ()):
                with on(sh["dev"]):
                    ftiles.append(extract_field_tiles(f, ltr, ltc, nyt, nxt,
                                                      g))
            pushed, jwin, kes, moms, disps = advance_shards(
                deck, mesh, modes, st.species, ftiles,
                [sh["origins"] for sh in shards], grid)
        with span("minipic.fields"):
            fnew, fes = fields_update(fpads, jwin)
        disp = pmax(disps, mesh)[0] if deck.species else None
        do_rebin, force, drift_now = sched.decide(st.step, st.drift, disp,
                                                  shift_now)
        with span("minipic.rebin"):
            binned, overflow, pending_total = rebin_species(
                deck, mesh, pushed, do_rebin, lambda ps, mc, sc: (
                    rebin_incremental(ps, force, mc, sc) if mc > 0
                    else rebin_sort(ps)))
        drift_now = sched.after(do_rebin, drift_now, pending_total)
        with span("minipic.diag"):
            diag = mesh_diag(deck, mesh, psum(fes, mesh)[0], kes, moms,
                             overflow, binned, do_rebin)
        species = [tuple(sp) for sp in binned]
        w0 = st.window_x0
        if shift_now:
            w0 = w0 + nxt
            with span("minipic.rebin"):
                fnew, species = shift_window(fnew, species, w0)
        return ShardedState(fields=fnew, species=species, step=st.step + 1,
                            drift=drift_now, window_x0=w0), diag

    return step


def shard_major_permutation(deck: Deck, mesh: Mesh) -> np.ndarray:
    """perm[shard_major_index] = gid (row-major global tile id): storage row
    s * T_local + local tile of shard s holds that gid's bucket."""
    rows, cols = mesh.shape
    ltr, ltc = local_tile_grid(deck, mesh)
    t = deck.tiling
    sr, sc, lr, lc = np.meshgrid(np.arange(rows), np.arange(cols),
                                 np.arange(ltr), np.arange(ltc),
                                 indexing="ij")
    return ((sr * ltr + lr) * t.tile_cols + (sc * ltc + lc)).reshape(-1)


class MeshSimulation(Driver):
    """The multi-device simulations' driver: ``simulation.Driver`` with the
    initial load on the mesh's first device put into the layout's storage
    order and split, the global ``state`` view, ``shard_state`` (what the
    step works on), and ``ensure_capacity`` that grows every shard alike.
    A subclass supplies ``storage_permutation``, ``_split`` and
    ``_assemble_fields``."""

    def __init__(self, deck: Deck, fields: Optional[FieldState], seed: int,
                 mesh: Mesh, build: Callable):
        self.deck, self.mesh = deck, mesh
        self.device = mesh.devices[0]
        for d in mesh.distinct():
            self.backend = resolve_backend(d)
        self._step = build(deck, mesh)
        self._start(fields, seed, self.storage_permutation())

    @property
    def state(self) -> SimState:
        """The global state in storage order, assembled on the mesh's first
        device (a copy: setting its tensors changes nothing; set
        ``state`` instead)."""
        st, dev = self._st, self.device
        n_sp = len(st.species[0]) if st.species else 0
        species = tuple(
            ParticleState(*(torch.cat([move(getattr(sp[i], n), dev)
                                       for sp in st.species])
                            for n in ParticleState._fields))
            for i in range(n_sp))
        return SimState(
            fields=self._assemble_fields(st.fields), species=species,
            step=torch.tensor(st.step, dtype=torch.int32, device=dev),
            drift=st.drift,
            window_x0=(None if st.window_x0 is None else torch.tensor(
                st.window_x0, dtype=torch.int32, device=dev)))

    @state.setter
    def state(self, state: SimState) -> None:
        T = self.deck.tiling.num_tiles
        S = self.mesh.size
        t_local = T // S
        species = []
        for s, dev in enumerate(self.mesh.devices):
            species.append(tuple(
                ParticleState(*(move(a[s * t_local:(s + 1) * t_local],
                                     dev).contiguous() for a in p))
                for p in state.species))
        drift = (torch.zeros((), dtype=torch.float32, device=self.device)
                 if state.drift is None
                 else move(state.drift.to(torch.float32), self.device))
        w0 = state.window_x0
        if w0 is None and self.deck.moving_window:
            w0 = 0
        self._st = ShardedState(
            fields=self._split(state.fields), species=species,
            step=int(state.step), drift=drift,
            window_x0=None if w0 is None else int(w0))

    @property
    def shard_state(self) -> ShardedState:
        """The per-shard state the step works on (no copy)."""
        return self._st

    @shard_state.setter
    def shard_state(self, st: ShardedState) -> None:
        self._st = st

    def ensure_capacity(self, overflow: int = 0) -> bool:
        """Grow every shard's buckets alike on overflow or high occupancy
        (``parallel.balance.CapacityManager`` over the mesh-wide census).
        Shrink is deferred, as in the JAX package: it would need a
        cross-shard positional re-bin, and spare capacity loses nothing."""
        from .balance import census_of_counts

        st = self._st
        changed = False
        species = [list(sp) for sp in st.species]
        for i, mgr in enumerate(self._managers()):
            counts = [(sp[i].w > 0).sum(1, dtype=torch.int32)
                      for sp in species]
            counts = torch.cat(move_all(counts, self.device))
            cap = species[0][i].capacity
            new_cap = mgr.plan(census_of_counts(counts, cap), overflow)
            if new_cap is None:
                continue
            new_cap = align_capacity(self.deck, new_cap)
            if new_cap > cap:
                for sp in species:
                    sp[i] = ParticleState(*(torch.nn.functional.pad(
                        a, (0, new_cap - cap)) for a in sp[i]))
                changed = True
        if changed:
            self._st = st._replace(species=[tuple(sp) for sp in species])
            self.capacity_changes += 1
        return changed


class ShardedSimulation(MeshSimulation):
    """Block-sharded simulation mirroring ``simulation.Simulation``: the deck's
    mesh (``mesh.make_mesh``) on the cards by default, every shard on
    `device` when one is given (``device="cpu"`` runs the plain
    versions)."""

    def __init__(self, deck: Deck, fields: Optional[FieldState] = None,
                 seed: int = 0, *, devices=None, device=None):
        deck.validate()
        super().__init__(deck, fields, seed,
                         make_mesh(deck, devices, device=device),
                         build_sharded_step)

    def storage_permutation(self) -> np.ndarray:
        return shard_major_permutation(self.deck, self.mesh)

    def _split(self, fields: FieldState) -> List[FieldState]:
        ny_l, nx_l = shard_shape(self.deck, self.mesh)
        out = []
        for s, dev in enumerate(self.mesh.devices):
            r, c = self.mesh.coords(s)
            out.append(FieldState(*(
                move(a[r * ny_l:(r + 1) * ny_l, c * nx_l:(c + 1) * nx_l],
                     dev).contiguous() for a in fields)))
        return out

    def _assemble_fields(self, fields: List[FieldState]) -> FieldState:
        rows, cols = self.mesh.shape
        dev = self.device
        return FieldState(*(
            torch.cat([torch.cat([move(getattr(fields[r * cols + c], n), dev)
                                  for c in range(cols)], dim=1)
                       for r in range(rows)], dim=0)
            for n in FieldState._fields))
