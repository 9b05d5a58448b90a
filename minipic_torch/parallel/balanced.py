"""Striped (balanced) tile placement over S shards (torch port of
``minipic_tpu.parallel.balanced``).

The block-sharded step keeps each shard's tiles contiguous, so a localized
concentration of particles (a blob, a wakefield snowplow, bunching) makes
one shard the straggler.  Here the tiles are dealt over the shards by a
skewed-diagonal map (``shard_of_tile``), so any concentration spreads over
all S shards to per-tile granularity, every step, with no migration.  The
grid is small and the particles big: the fields are replicated on every
device and the particles stay sharded.

Per step:

  1. the replicated fields halo-padded once per device, each shard's tile
     windows taken from them;
  2. the advance on the shard's buckets with each tile's window-gid origin;
  3. each shard's J windows laid into a full-grid canvas and summed over
     the devices (the JAX package's ``psum``), then the periodic guard fold;
  4. the Yee update, once per device (every shard on a device shares it);
  5. re-bin: the split with each bucket's window gid (``tile_ids``), the
     mover buffers gathered (once per device), each mover routed to the
     bucket of the shard that owns its destination (one stable sort per
     device, which orders every bucket's arrivals as the per-shard sort of
     the JAX package does; the gather is the ``minipic.parallel`` span, the
     route the re-bin's), then append_incoming or the defrag under a
     mesh-agreed flag; the sort fallback without a mover buffer;
  6. moving window: no bucket moves — the gid <-> storage map rotates by
     the shift count, positions shift by a tile, and the buckets of the
     trailing storage column take fresh plasma.

``BalancedSimulation.state`` assembles the global SimState in the striped
storage order (``balanced_permutation``), fields once.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import Deck
from ..core.state import CurrentState, FieldState, ParticleState, field_energy
from ..fields.boundary import apply_damping, damping_mask
from ..fields.halo import fold_block_periodic, pad_fields_periodic
from ..fields.tiles import extract_field_tiles, fold_tiles
from ..fields.yee import update_b_half_periodic, update_e_full_periodic
from ..ops.rebin import append_incoming_, defrag_buckets_, split_buckets
from ..particles import species as species_mod
from ..particles.binning import finish_rebin, rebin_by_tid
from ..simulation import (Schedule, StepDiag, deposit_modes, resolve_backend,
                          window_injection_key, window_shift_now)
from ..trace import span
from .mesh import (Mesh, all_gather, default_devices, move, move_all, on,
                   pall, pmax, psum)
from .step import (MeshSimulation, ShardedState, advance_shards, flag_on,
                   mesh_diag, rebin_species)


def shard_of_tile(tile_rows: int, tile_cols: int, n_shards: int) -> np.ndarray:
    """[T] gid -> shard: the skewed-diagonal interleave shard = (a*row +
    col) % S with a ~ S/2 coprime to S (plain gid % S degenerates to whole
    column stripes when tile_cols % S == 0).  Round-robin over the
    row-major scan when tile_cols % S != 0."""
    gid = np.arange(tile_rows * tile_cols)
    row, col = gid // tile_cols, gid % tile_cols
    if tile_cols % n_shards == 0:
        a = max(1, n_shards // 2)
        while n_shards > 1 and np.gcd(a, n_shards) != 1:
            a += 1
        return ((a * row + col) % n_shards).astype(np.int64)
    return (gid % n_shards).astype(np.int64)


def stripe_gids(tile_rows: int, tile_cols: int, n_shards: int) -> np.ndarray:
    """[S, T_local]: the (sorted) global tile ids owned by each shard."""
    shard = shard_of_tile(tile_rows, tile_cols, n_shards)
    t_local = tile_rows * tile_cols // n_shards
    out = np.empty((n_shards, t_local), np.int64)
    for s in range(n_shards):
        mine = np.nonzero(shard == s)[0]
        if len(mine) != t_local:
            raise ValueError("the stripe map does not partition evenly")
        out[s] = mine
    return out


def balanced_permutation(num_tiles: int, n_shards: int,
                         tile_rows: int, tile_cols: int) -> np.ndarray:
    """perm[storage_row] = gid of the striped layout: storage row
    s*T_local + j holds stripe_gids[s, j]."""
    return stripe_gids(tile_rows, tile_cols, n_shards).reshape(num_tiles)


def build_balanced_step(deck: Deck, mesh: Mesh) -> Callable:
    """Step function ShardedState -> (ShardedState, StepDiag) over the
    `mesh.size` shards of `mesh` (its shape does not matter: the stripes
    are a 1-D deal).  Shards on one device share its field tensors."""
    deck.validate()
    for d in mesh.distinct():
        resolve_backend(d)
    S = mesh.size
    tiling = deck.tiling
    T = tiling.num_tiles
    if T % S:
        raise ValueError(f"{T} tiles not divisible by {S} shards")
    t_local = T // S
    g = deck.guard
    dt, dx, dy = deck.dt, deck.dx, deck.dy
    nyt, nxt = tiling.tile_ny, tiling.tile_nx
    tr, tc = tiling.tile_rows, tiling.tile_cols
    periodic = deck.boundary == "periodic"
    grid = (deck.nx, deck.ny) if periodic else None
    sched = Schedule(deck)
    modes = deposit_modes(deck)
    devs = mesh.distinct()
    dev0 = mesh.devices[0]
    masks = {d: (None if periodic else damping_mask(
        deck.ny, deck.nx, deck.absorb_width, dtype=deck.dtype, device=d))
        for d in devs}
    stripe = stripe_gids(tr, tc, S)
    shard_of = shard_of_tile(tr, tc, S)
    local_of = np.zeros(T, np.int64)
    for s in range(S):
        local_of[stripe[s]] = np.arange(t_local)
    # Storage row of each gid's bucket: the route's sort key.
    storage_np = shard_of * t_local + local_of
    storage_of = {d: torch.as_tensor(storage_np, device=d) for d in devs}
    shards = [dict(dev=d, grow_np=stripe[s] // tc, gcol_np=stripe[s] % tc,
                   grow=torch.as_tensor(stripe[s] // tc, device=d),
                   gcol_st=torch.as_tensor(stripe[s] % tc, device=d))
              for s, d in enumerate(mesh.devices)]
    tables = {}

    def tile_tables(k: int):
        """Per shard (window gid int32 [T_local], origins) after k window
        shifts: storage bucket (r, c) holds window tile (r, (c - k) % tc)."""
        if k not in tables:
            tables.clear()
            out = []
            for sh in shards:
                gcol = torch.remainder(sh["gcol_st"] - k, tc)
                gid = (sh["grow"] * tc + gcol).to(torch.int32)
                out.append((gid, ((gcol * nxt).to(torch.int32),
                                  (sh["grow"] * nyt).to(torch.int32))))
            tables[k] = out
        return tables[k]

    def dest_storage(pool: ParticleState, k: int, d):
        """(storage row, on the grid) of each slot's destination: its window
        tile, rotated to storage by the k window shifts."""
        col = torch.clamp(torch.floor(pool.x / nxt).to(torch.int64), 0,
                          tc - 1)
        row = torch.clamp(torch.floor(pool.y / nyt).to(torch.int64), 0,
                          tr - 1)
        col = torch.remainder(col + k, tc)
        on_grid = ((pool.x >= 0) & (pool.x < deck.nx) & (pool.y >= 0)
                   & (pool.y < deck.ny))
        return storage_of[d][row * tc + col], on_grid

    def rebin_incremental(ps, force, mc, k):
        """Split with window gids, gather the movers, route, append."""
        gids = [gid for gid, _ in tile_tables(k)]
        cap = ps[0].capacity
        splits = []
        for sh, p, gid in zip(shards, ps, gids):
            with on(sh["dev"]):
                splits.append(split_buckets(
                    p, tile_cols=tc, tile_ny=nyt, tile_nx=nxt, b_cap=mc,
                    force=flag_on(force, sh["dev"]), tile_ids=gid))
        # The gathered pool, routed once per device: a stable sort by
        # storage row keeps each bucket's arrivals in pool order, as the
        # JAX package's per-shard sort of the same pool does.
        pools = {}
        ovf = None
        for d in devs:
            with on(d):
                pool = ParticleState(*(torch.cat(move_all(
                    [m[ci].reshape(-1) for _, m, _, _ in splits], d))
                    for ci in range(6)))
                key, on_grid = dest_storage(pool, k, d)
                pool = pool._replace(w=torch.where(
                    on_grid, pool.w, torch.zeros_like(pool.w)))
                inc, ov = rebin_by_tid(pool, key, torch.ones_like(on_grid),
                                       T, mc)
            pools[d] = inc
            ovf = ov if ovf is None else ovf
        incoming, oks = [], []
        for s, (sh, (_, _, wm, _)) in enumerate(zip(shards, splits)):
            inc = pools[sh["dev"]]
            with on(sh["dev"]):
                inc = ParticleState(*(a[s * t_local:(s + 1) * t_local]
                                      for a in inc))
                n_in = (inc.w > 0).sum(1, dtype=torch.int32)
                oks.append((wm + n_in <= cap - 256).all())
            incoming.append(inc)
        ok = pall(oks, mesh)
        out, ovs, pends = [], [], []
        for s, (sh, (p1, _, wm, pending), inc, okk) in enumerate(zip(
                shards, splits, incoming, ok)):
            with on(sh["dev"]):
                app = append_incoming_(p1, inc, wm, active=okk)
                _, dd = defrag_buckets_(p1, inc, active=~okk)
                dropped = (app.sum() + dd.sum()).to(torch.int32)
                if s == 0:  # the route's overflow, counted once
                    dropped = dropped + move(ovf, sh["dev"])
                dropped, pend = finish_rebin(dropped, pending,
                                             flag_on(force, sh["dev"]))
            out.append(p1)
            ovs.append(dropped)
            pends.append(pend)
        return out, ovs, pends

    def rebin_sort(ps, mc, k):
        """Fallback without a mover buffer: each shard's off-stripe movers
        into a fixed buffer, gathered, then one sort per shard over its
        stayers and the arrivals (the JAX package's do_rebin_sort)."""
        cap_b = max(mc, 1024)
        bufs, stays, drops = [], [], []
        for s, (sh, p) in enumerate(zip(shards, ps)):
            with on(sh["dev"]):
                flat = ParticleState(*(a.reshape(-1) for a in p))
                key, on_grid = dest_storage(flat, k, sh["dev"])
                mine = (torch.div(key, t_local, rounding_mode="floor")
                        == s) & on_grid
                moving = (flat.w > 0) & ~mine
                rank = torch.cumsum(moving.to(torch.int32), 0) - 1
                drops.append((moving & (rank >= cap_b)).sum(
                    dtype=torch.int32))
                dest = torch.where(moving & (rank < cap_b), rank,
                                   torch.full_like(rank, cap_b)).long()
                f6 = torch.stack(tuple(flat))
                buf = torch.zeros((6, cap_b + 1), dtype=f6.dtype,
                                  device=sh["dev"])
                buf[:, dest] = torch.where(moving, f6, torch.zeros_like(f6))
                bufs.append(buf[:, :cap_b])
                stays.append(ParticleState(*(torch.where(
                    moving, torch.zeros_like(a), a) for a in flat)))
        gathered = all_gather(bufs, mesh, dim=1)
        out, ovs = [], []
        for s, (sh, stay, gat, dr) in enumerate(zip(shards, stays, gathered,
                                                    drops)):
            with on(sh["dev"]):
                pool = ParticleState(*(torch.cat([a, b]) for a, b in
                                       zip(stay, gat)))
                key, on_grid = dest_storage(pool, k, sh["dev"])
                mine = (torch.div(key, t_local, rounding_mode="floor")
                        == s) & on_grid
                pool = pool._replace(w=torch.where(mine, pool.w,
                                                   torch.zeros_like(pool.w)))
                q, ov = rebin_by_tid(pool, key - s * t_local,
                                     torch.ones_like(mine), t_local,
                                     ps[s].capacity)
            out.append(q)
            ovs.append(ov + dr)
        zeros = [torch.zeros((), dtype=torch.int32, device=sh["dev"])
                 for sh in shards]
        return out, ovs, zeros

    def current(tabs, jwin):
        """J per device: every shard's windows laid into a full-grid
        canvas on its device, the canvases summed over the devices, then
        the periodic guard fold."""
        canvases = []
        for d in devs:
            with on(d):
                full = torch.zeros((3, T, nyt + 2 * g, nxt + 2 * g),
                                   dtype=deck.dtype, device=d)
                for sh, (gid, _), js in zip(shards, tabs, jwin):
                    if sh["dev"] == d:
                        full.index_copy_(1, gid.long(), torch.stack(js))
                canvases.append(torch.stack([
                    fold_tiles(c.reshape(tr, tc, nyt + 2 * g, nxt + 2 * g),
                               nyt, nxt, g) for c in full]))
        total = psum(canvases, Mesh(devs, 1, len(devs)))
        j = {}
        for d, c in zip(devs, total):
            with on(d):
                j[d] = CurrentState(*(fold_block_periodic(a, g) for a in c))
        return j

    def step(st: ShardedState) -> Tuple[ShardedState, StepDiag]:
        shift_now = False
        k = 0
        if deck.moving_window:
            if st.window_x0 is None:
                raise ValueError("deck.moving_window but the window origin "
                                 "is unset (BalancedSimulation sets it)")
            shift_now = bool(window_shift_now(st.step, st.window_x0, dt,
                                              nxt, dx))
            k = st.window_x0 // nxt
        tabs = tile_tables(k)
        # One field copy per device (shards on a device share it).
        fields = {}
        for sh, f in zip(shards, st.fields):
            fields.setdefault(sh["dev"], f)
        with span("minipic.advance"):
            # Each shard's windows from its device's padded fields.
            wins, ftiles = {}, []
            for sh, (gid, _) in zip(shards, tabs if deck.species else ()):
                d = sh["dev"]
                with on(d):
                    if d not in wins:
                        wins[d] = extract_field_tiles(
                            pad_fields_periodic(fields[d], g), tr, tc, nyt,
                            nxt, g)
                    ftiles.append(FieldState(*(
                        c.index_select(0, gid.long()) for c in wins[d])))
            pushed, jwin, kes, moms, disps = advance_shards(
                deck, mesh, modes, st.species, ftiles,
                [origins for _, origins in tabs], grid)
        with span("minipic.fields"):
            j = current(tabs, jwin) if deck.species else {}
            for d in devs:
                with on(d):
                    f = update_b_half_periodic(fields[d], dt, dx, dy)
                    f = update_e_full_periodic(f, dt, dx, dy, j.get(d))
                    f = update_b_half_periodic(f, dt, dx, dy)
                    if masks[d] is not None:
                        f = apply_damping(f, masks[d])
                    fields[d] = f
        disp = pmax(disps, mesh)[0] if deck.species else None
        do_rebin, force, drift_now = sched.decide(st.step, st.drift, disp,
                                                  shift_now)
        with span("minipic.rebin"):
            binned, overflow, pending_total = rebin_species(
                deck, mesh, pushed, do_rebin, lambda ps, mc, sc: (
                    rebin_incremental(ps, force, mc, k) if mc > 0
                    else rebin_sort(ps, mc, k)))
        drift_now = sched.after(do_rebin, drift_now, pending_total)
        with span("minipic.diag"):
            diag = mesh_diag(deck, mesh, field_energy(fields[dev0], dx, dy),
                             kes, moms, overflow, binned, do_rebin)
        w0 = st.window_x0
        species = [tuple(sp) for sp in binned]
        if shift_now:
            w0 = w0 + nxt
            with span("minipic.rebin"):
                for d in devs:
                    with on(d):
                        keep = (torch.arange(deck.nx, device=d)
                                < deck.nx - nxt)
                        fields[d] = FieldState(*(torch.where(
                            keep, torch.roll(c, -nxt, dims=1),
                            torch.zeros_like(c)) for c in fields[d]))
                species = shift_buckets(species, w0, k)
        return ShardedState(
            fields=[fields[sh["dev"]] for sh in shards], species=species,
            step=st.step + 1, drift=drift_now, window_x0=w0), diag

    def shift_buckets(species, w0n: int, k: int):
        """Positions shift a tile left; the buckets of the trailing storage
        column (k mod tc, whose window column wraps to the leading one)
        take fresh plasma, keyed per global tile row."""
        out = []
        for sh, sp in zip(shards, species):
            inj = np.nonzero(sh["gcol_np"] == k % tc)[0]
            new = []
            with on(sh["dev"]):
                idx = torch.as_tensor(inj, device=sh["dev"])
                for i, (spec, p) in enumerate(zip(deck.species, sp)):
                    chans = [p.x - nxt, *p[1:]]
                    if len(inj):
                        fresh = species_mod.inject_column(
                            spec, deck.domain, tiling, p.capacity,
                            window_injection_key(i, w0n), w0n, deck.dtype,
                            sh["dev"], row_ids=sh["grow_np"][inj])
                        chans = [a.index_copy(0, idx, b)
                                 for a, b in zip(chans, fresh)]
                    new.append(ParticleState(*chans))
            out.append(tuple(new))
        return out

    return step


class BalancedSimulation(MeshSimulation):
    """Striped-placement simulation (``ShardedSimulation``'s surface, another
    tile -> shard map).  Its shards are `devices`, or the deck's
    ``mesh.default_devices`` (every shard on `device` when one is
    given)."""

    def __init__(self, deck: Deck, fields: Optional[FieldState] = None,
                 seed: int = 0, *, devices=None, device=None):
        deck.validate()
        devices = list(devices if devices is not None
                       else default_devices(deck, device))
        super().__init__(deck, fields, seed, Mesh(devices, 1, len(devices)),
                         build_balanced_step)

    def storage_permutation(self) -> np.ndarray:
        t = self.deck.tiling
        return balanced_permutation(t.num_tiles, self.mesh.size, t.tile_rows,
                                    t.tile_cols)

    def _split(self, fields: FieldState) -> List[FieldState]:
        per_dev = {d: FieldState(*(move(a, d).contiguous() for a in fields))
                   for d in self.mesh.distinct()}
        return [per_dev[d] for d in self.mesh.devices]

    def _assemble_fields(self, fields: List[FieldState]) -> FieldState:
        return FieldState(*(move(a, self.device) for a in fields[0]))
