"""How what a step produced is held to the reference's step.

Both sides are lists of live particles (with the bucket each sits in), six
field components and the step's diagnostics.  The particles are paired one
to one: within a bucket, by position (a sorted key of bucket and x, then the
nearest candidates in all six channels, each within its tolerance); what is
left is paired across buckets, and such a pair is allowed only where the
program put the particle in the bucket of its own position (the two sides'
positions straddle a tile edge by a rounding) or, on a re-bin that left
movers pending or a step after which the capacity policy changed the
buckets, in the bucket it came from.  So a step that grows or shrinks the
buckets is held to the reference like any other, particle by particle.
Between absorbing walls an
unpaired particle within a hair of a wall is excused: the kill may go either
way on a rounding.

The numbers compared (``compare``):

* ``x_gap`` (cells), ``p_gap`` and ``w_gap`` (of the largest |momentum| and
  weight): the widest gap of a paired particle;
* ``field_gap``: the widest gap of E and of B, each over its largest value;
* ``energy_gap``: the field energy's and the kinetic energies' gaps over
  the total energy;
* ``momentum_gap``: the widest gap of a species' momentum along an axis,
  over the sum of w m |u| along it;
* ``drift_gap`` (cells): the accumulated drift the step leaves, against
  the reference's (0 after a re-bin, so a re-bin taken or skipped against
  the reference's decision reads the whole drift; either is right where the
  drift lies within a hair of the threshold);
* ``particles_off``: particles whose bookkeeping is wrong: those without a
  partner, less those a re-bin dropped and counted (``overflow``); after a
  re-bin that left nothing pending, live particles outside the bucket of
  their position; and the step's live count against the reference's.  The
  harness adds to it, for a periodic deck, the window's live particles
  summed over its steps against the inputs' count less what re-bins
  dropped and counted (``cell.check``).

A deck without species pairs nothing: its particle numbers read 0, and the
fields and the field energy decide.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from .step import Flat, Geometry, Result, drift_threshold, geometry, home_tile

# Pairing tolerances: positions in cells; momenta and weights as shares of
# the reference's largest |momentum| and weight.  Far above rounding (a
# float32 position near 512 rounds at 6e-5) and far below the gaps that a
# lost update or a lower precision leaves.
POS_TOL = 1e-3
REL_TOL = 1e-3
# Judged particles a block of the pairing, and (particle, candidate) pairs
# a block may hold.
BLOCK = 1 << 21
CELLS = 1 << 24
WALL_EPS = 2e-3
DRIFT_EPS = 1e-4
NUMBERS = ("x_gap", "p_gap", "w_gap", "field_gap", "energy_gap",
           "momentum_gap", "drift_gap", "particles_off")


class Produced(NamedTuple):
    """What the judged side produced in a step."""

    species: Tuple[Flat, ...]
    fields: Tuple[torch.Tensor, ...]
    field_energy: float
    kinetic: Tuple[float, ...]
    momentum: Tuple[Tuple[float, ...], ...]
    live: int
    overflow: int
    rebinned: bool
    drift: float
    # the capacity policy changed the buckets after the step (grown in
    # place, or shrunk by a re-bin of the slot pool)
    relaid: bool = False


def from_result(res: Result, geo: Geometry) -> Produced:
    """A reference step's result as the judged side (the control)."""
    species = tuple(p._replace(tile=home_tile(p.x, p.y, geo))
                    if res.rebinned else p for p in res.species)
    return Produced(species, res.fields, res.field_energy, res.kinetic,
                    res.momentum, res.live, 0, res.rebinned, res.drift)


class _Pairs(NamedTuple):
    ref_idx: torch.Tensor  # [n_prog] int64, -1 where unpaired
    pos_gap: float
    p_gap: float
    w_gap: float


def _pair(prog: Flat, ptile, ref: Flat, rtile, scales, use_tile: bool,
          kx: float) -> _Pairs:
    """Pair each judged particle with a reference one (see the module
    docstring); `ptile` and `rtile` are the buckets the keys sort by."""
    dev = prog.x.device
    n_ref = ref.x.shape[0]
    n = prog.x.shape[0]
    out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    gaps = [0.0, 0.0, 0.0]
    if n == 0 or n_ref == 0:
        return _Pairs(out, *gaps)
    f64 = torch.float64
    rkey = ref.x.to(f64) + (rtile.to(f64) * kx if use_tile else 0.0)
    order = torch.argsort(rkey)
    rkey = rkey[order]
    ref_ch = [a.to(f64) for a in ref[1:]]
    tols = (POS_TOL, POS_TOL) + (REL_TOL * scales[0],) * 3 + (
        REL_TOL * scales[1],)
    pkeys = prog.x.to(f64) + (ptile.to(f64) * kx if use_tile else 0.0)
    lo = torch.searchsorted(rkey, pkeys - POS_TOL)
    hi = torch.searchsorted(rkey, pkeys + POS_TOL, right=True)
    s = 0
    while s < n:
        # As many candidates as the most crowded key in the block has: a
        # lattice of particles at rest shares each x exactly.
        width = max(1, int((hi[s:s + BLOCK] - lo[s:s + BLOCK]).max()))
        size = max(1024, min(BLOCK, CELLS // width))
        sl = slice(s, s + size)
        s += size
        width = max(1, int((hi[sl] - lo[sl]).max()))
        pch = [a[sl].to(f64) for a in prog[1:]]
        pos = lo[sl][:, None] + torch.arange(width, device=dev)
        ok = pos < hi[sl][:, None]
        cand = order[pos.clamp(max=n_ref - 1)]
        if use_tile:
            ok &= rtile[cand] == ptile[sl][:, None]
        score = torch.zeros(cand.shape, dtype=f64, device=dev)
        chan_gaps = []
        for rc, pc, tol in zip(ref_ch, pch, tols):
            g = (rc[cand] - pc[:, None]).abs()
            ok &= g <= tol
            score += g / tol
            chan_gaps.append(g)
        score = torch.where(ok, score, torch.full_like(score, float("inf")))
        best_score, best = score.min(dim=1)
        paired = torch.isfinite(best_score)
        pick = best[:, None]
        out[sl] = torch.where(paired, cand.gather(1, pick)[:, 0],
                              torch.full_like(best, -1))
        if bool(paired.any()):
            sel = [g.gather(1, pick)[:, 0][paired] for g in chan_gaps]
            gaps[0] = max(gaps[0], float(torch.maximum(sel[0], sel[1]).max()))
            gaps[1] = max(gaps[1], float(torch.stack(sel[2:5]).max())
                          / scales[0])
            gaps[2] = max(gaps[2], float(sel[5].max()) / scales[1])
    return _Pairs(out, *gaps)


def _near_wall(p: Flat, geo: Geometry) -> torch.Tensor:
    return ((p.x < WALL_EPS) | (p.x > geo.nx - WALL_EPS)
            | (p.y < WALL_EPS) | (p.y > geo.ny - WALL_EPS))


def _species_numbers(prog: Flat, ref: Flat, geo: Geometry, rebinned: bool,
                     pending: bool, relaid: bool, scales) -> Dict[str, float]:
    """Pair one species' particles; returns the gaps and the counts of
    unpaired particles on each side (excused ones apart)."""
    kx = float(geo.nx + 64)
    rtile = home_tile(ref.x, ref.y, geo) if rebinned else ref.tile
    first = _pair(prog, prog.tile, ref, rtile, scales, True, kx)
    dev = prog.x.device
    ref_taken = torch.zeros(ref.x.shape[0], dtype=torch.bool, device=dev)
    got = first.ref_idx >= 0
    idx = first.ref_idx[got]
    uniq = torch.unique(idx)
    ref_taken[uniq] = True
    extra_prog = int(idx.numel() - uniq.numel())  # two paired to one
    gaps = [first.pos_gap, first.p_gap, first.w_gap]
    misplaced = 0
    left_p = (~got).nonzero(as_tuple=True)[0]
    left_r = (~ref_taken).nonzero(as_tuple=True)[0]
    if (rebinned or relaid) and left_p.numel() and left_r.numel():
        lp = Flat(*(a[left_p] for a in prog))
        lr = Flat(*(a[left_r] for a in ref))
        second = _pair(lp, lp.tile, lr, lr.tile, scales, False, kx)
        ok2 = second.ref_idx >= 0
        if bool(ok2.any()):
            ridx = second.ref_idx[ok2]
            ptile = lp.tile[ok2]
            allowed = ptile == home_tile(lp.x[ok2], lp.y[ok2], geo)
            if pending or relaid:
                allowed |= ptile == lr.tile[ridx]
            misplaced = int((~allowed).sum())
            ref_taken[left_r[torch.unique(ridx)]] = True
            still = torch.ones(left_p.numel(), dtype=torch.bool, device=dev)
            still[ok2.nonzero(as_tuple=True)[0]] = False
            left_p = left_p[still]
            gaps = [max(a, b) for a, b in zip(
                gaps, (second.pos_gap, second.p_gap, second.w_gap))]
    left_r = (~ref_taken).nonzero(as_tuple=True)[0]
    unp_prog = Flat(*(a[left_p] for a in prog))
    unp_ref = Flat(*(a[left_r] for a in ref))
    excused = 0
    if not geo.periodic:
        wp, wr = _near_wall(unp_prog, geo), _near_wall(unp_ref, geo)
        excused = int(wp.sum()) + int(wr.sum())
        n_prog, n_ref = int((~wp).sum()), int((~wr).sum())
    else:
        n_prog, n_ref = left_p.numel(), left_r.numel()
    return dict(pos=gaps[0], p=gaps[1], w=gaps[2],
                unpaired_prog=n_prog + extra_prog + misplaced,
                unpaired_ref=n_ref, excused=excused)


def compare(prod: Produced, ref: Result, deck: dict) -> Dict[str, float]:
    """The numbers compared for one step (see the module docstring)."""
    geo = geometry(deck)
    pending = prod.rebinned and prod.drift != 0.0
    p_scale = max((float(torch.stack([p.px.abs().max(), p.py.abs().max(),
                                      p.pz.abs().max()]).max())
                   for p in ref.species if p.x.numel()), default=1.0)
    w_scale = max((float(p.w.max()) for p in ref.species if p.x.numel()),
                  default=1.0)
    scales = (p_scale or 1.0, w_scale or 1.0)
    per = [_species_numbers(pp, rp, geo, prod.rebinned, pending, prod.relaid,
                            scales)
           for pp, rp in zip(prod.species, ref.species)]
    unpaired_prog = sum(d["unpaired_prog"] for d in per)
    unpaired_ref = sum(d["unpaired_ref"] for d in per)
    excused = sum(d["excused"] for d in per)

    def rel(a, b):
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())

    e_scale = max(float(c.abs().max()) for c in ref.fields[:3]) or 1.0
    b_scale = max(float(c.abs().max()) for c in ref.fields[3:]) or 1.0
    field_gap = max(max(rel(a, b) for a, b in
                        zip(prod.fields[:3], ref.fields[:3])) / e_scale,
                    max(rel(a, b) for a, b in
                        zip(prod.fields[3:], ref.fields[3:])) / b_scale)
    total = ref.field_energy + sum(ref.kinetic)
    energy_gap = max(abs(prod.field_energy - ref.field_energy),
                     sum(abs(a - b) for a, b in
                         zip(prod.kinetic, ref.kinetic))) / (total or 1.0)
    mom_scale = [sum(m[a] for m in ref.momentum_abs) or 1.0
                 for a in range(3)]
    momentum_gap = max((abs(pm[a] - rm[a]) / mom_scale[a]
                        for pm, rm in zip(prod.momentum, ref.momentum)
                        for a in range(3)), default=0.0)
    near = abs(ref.drift_now - drift_threshold(deck)) < DRIFT_EPS
    pending_drift = ref.drift_now if pending else 0.0
    after = {ref.rebinned} | ({True, False} if near else set())
    drift_gap = min(abs(prod.drift - (pending_drift if r else ref.drift_now))
                    for r in after)
    stray = 0
    if prod.rebinned and not pending:
        stray = sum(int((p.tile != home_tile(p.x, p.y, geo)).sum())
                    for p in prod.species)
    live_off = max(0, abs(prod.live - (ref.live - prod.overflow)) - excused)
    return {
        "x_gap": max((d["pos"] for d in per), default=0.0),
        "p_gap": max((d["p"] for d in per), default=0.0),
        "w_gap": max((d["w"] for d in per), default=0.0),
        "field_gap": field_gap,
        "energy_gap": energy_gap,
        "momentum_gap": momentum_gap,
        "drift_gap": drift_gap,
        "particles_off": (unpaired_prog + max(0, unpaired_ref - prod.overflow)
                          + stray + live_off),
    }


def worst(readings) -> Dict[str, float]:
    """The worst of several steps' readings, number by number."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(reading: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}}).  A number
    without a limit, or a limit without a number, is not correct."""
    checks = {k: {"value": reading.get(k, float("inf")), "limit": lim}
              for k, lim in limits.items()}
    ok = set(reading) == set(limits) and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def expected_modes(deck: dict) -> Tuple[str, ...]:
    """Each species' deposit as the configuration states it: "f64" for a
    float64 deck; "int8" where asked, every weight is equal by the way the
    species is loaded (no density profile, or count loading with a stated
    n_max) and the tile window holds the int8 deposit's layout
    (6 (tile_ny + 2g) <= 128, 2 (tile_nx + 2g) <= 128, (tile_ny + 2g) % 8
    == 0); else "f32"."""
    if deck["precision"] == "f64":
        return tuple("f64" for _ in deck["species"])
    nyg = deck["tile_ny"] + 2 * deck["guard"]
    nxg = deck["tile_nx"] + 2 * deck["guard"]
    window = 6 * nyg <= 128 and 2 * nxg <= 128 and nyg % 8 == 0

    def equal_weights(sp):
        return sp.get("density") is None or (
            sp.get("load_mode") == "count" and sp.get("n_max") is not None)

    return tuple("int8" if deck.get("deposit") == "int8" and window
                 and equal_weights(sp) else "f32"
                 for sp in deck["species"])
