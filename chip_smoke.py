#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``minipic_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing what it found; any failure exits non-zero:

1. build: compiles the advance kernel (csrc/advance.cu) and the re-bin
   kernels (csrc/rebin.cu) from this checkout, one nvcc each, at once;
2. kernel: the advance kernel against its plain torch version on the card,
   on 64 tiles of the headline tile shape (8x8, guard 4, 27136 slots,
   thermal particles, non-zero fields) in int8 and f32 modes, TSC and CIC;
   then each re-bin kernel (split, segment, append, defrag) against its
   plain version on 64 headline-shaped tiles with stale buckets, equal in
   every channel of every slot: normal, pending, forced, segment overflow,
   a >1-hop mover, and a crowded state whose re-bin takes the defrag;
3. small step: two 32^2 decks stepped on the card (kernels) against the
   same state stepped on the CPU (plain versions): the sort route, and the
   deal route (ppc 40, buckets big enough for it);
4. main path: bench.py's headline deck exactly (1e8 particles, 512^2, TSC,
   int8, whole-bucket chunks, the default deal-route re-bin), 60
   ``Simulation.step`` calls on the card; then each kernel against its plain
   version on the run's final state, at the main path's shapes, and each
   one's time, with the whole deal-route re-bin and the sort re-bin;
5. sort route: the headline deck with ``rebin_mode="sort"``, 20 steps with
   one forced re-bin.

The line before last is a JSON object with each kernel's launches on the
main path, its error against the plain version and both times; the last
line is ``{"ok": true, "device": {...}}``.  Needs CUDA: without a card it
fails before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_STEPS = 60
SORT_STEPS = 20
SUBSET_TILES = 64
ADVANCE_SOURCE = "minipic_torch/csrc/advance.cu"
REBIN_SOURCE = "minipic_torch/csrc/rebin.cu"
RK = "minipic_tpu/ops/pallas/rebin_kernels.py"
# name -> (source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "advance": (ADVANCE_SOURCE, "minipic_tpu/ops/pallas/ppd_kernel.py:1187"),
    "split": (REBIN_SOURCE, f"{RK}:719"),
    "segment": (REBIN_SOURCE, f"{RK}:1009"),
    "append": (REBIN_SOURCE, f"{RK}:1457"),
    "defrag": (REBIN_SOURCE, f"{RK}:1201"),
}
# int8 jx/jy are integer sums, exact in any order, so kernel and plain
# version agree cell for cell unless a position differs by 1 ulp and moves
# a shape quantum; allow a few such cells per comparison.
MAX_INT8_CELLS_DIFFERENT = 16


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of fn() in ms over `reps` calls (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from minipic_torch.ops._build import SOURCES, build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(build, SOURCES)))
    for src, b in built.items():
        print(f"build: minipic_torch/csrc/{src} -> "
              f"{b.path.relative_to(ROOT)} in {b.seconds:.1f} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: ptxas: {line.strip()}")
    print(f"build: {len(built)} libraries in "
          f"{time.perf_counter() - t0:.1f} s")


def _subset(order: int, dev):
    """64 tiles of the headline tile shape with thermal particles displaced
    up to 1 cell off their tiles (stale buckets) and smooth fields."""
    import torch

    from minipic_torch import headline
    from minipic_torch.core.state import FieldState
    from minipic_torch.fields.halo import pad_fields_periodic
    from minipic_torch.fields.tiles import extract_field_tiles
    from minipic_torch.particles.species import load_species
    from minipic_torch.simulation import BUCKET_ALIGN

    deck = headline.headline_deck(grid=64, order=order)
    t = deck.tiling
    check(t.num_tiles == SUBSET_TILES, "subset tiling")
    cap = -(-deck.capacity() // BUCKET_ALIGN) * BUCKET_ALIGN
    gen = torch.Generator(device=dev).manual_seed(11)
    p = load_species(deck.species[0], deck.domain, t, cap, gen,
                     torch.float32, dev)
    live = p.w > 0
    shift = [torch.rand(p.x.shape, generator=gen, device=dev) * 2.0 - 1.0
             for _ in range(2)]
    x = torch.where(live, torch.remainder(p.x + shift[0], deck.nx), p.x)
    y = torch.where(live, torch.remainder(p.y + shift[1], deck.ny), p.y)
    x = torch.where(x >= deck.nx, x - deck.nx, x)
    y = torch.where(y >= deck.ny, y - deck.ny, y)
    p = p._replace(x=x, y=y)
    j = torch.arange(deck.ny, device=dev, dtype=torch.float32)[:, None]
    i = torch.arange(deck.nx, device=dev, dtype=torch.float32)[None, :]
    k = 2 * torch.pi / deck.nx
    f = FieldState(*(0.05 * torch.sin(k * ((c + 1) * i + (2 - c) * j) + c)
                     for c in range(6)))
    ft = extract_field_tiles(pad_fields_periodic(f, deck.guard), t.tile_rows,
                             t.tile_cols, t.tile_ny, t.tile_nx, deck.guard)
    return deck, p, ft


def _kw(deck, mode):
    t = deck.tiling
    return dict(qm=-1.0, q=-1.0, order=deck.species[0].shape_order,
                tile_ny=t.tile_ny, tile_nx=t.tile_nx, tile_cols=t.tile_cols,
                g=deck.guard, dt=deck.dt, dx=deck.dx, dy=deck.dy,
                grid=(deck.nx, deck.ny), mode=mode)


def _continuity(deck, p0, mode, ft):
    """max |(rho1 - rho0)/dt + div J| / (max|rho0|/dt) of the kernel's own
    int8 output, with rho from the same quantized shapes.  The dense rho
    diagnostic runs on the CPU, as in the CPU tests, so that the residual
    measures the kernel's J: formed on the card (H100), the f32 matmul over
    a tile's 27136 slots alone left 2.8e-6 of scale."""
    import torch

    from minipic_torch.ops.advance import (fused_push_deposit,
                                           live_watermark, qshape_scale)
    from minipic_torch.particles.deposit import deposit_rho_chunk
    from minipic_torch.simulation import tile_local_coords, tile_origins

    t = deck.tiling
    order = deck.species[0].shape_order
    cpu = torch.device("cpu")
    origins = tile_origins(t, torch.float32, cpu)

    def rho(p):
        p = type(p)(*(a.to(cpu) for a in p))
        xi, eta = tile_local_coords(p.x, p.y, origins, t.tile_nx, t.tile_ny,
                                    (deck.nx, deck.ny))
        return deposit_rho_chunk(xi, eta, -p.w, t.tile_ny, t.tile_nx,
                                 deck.guard, order, deck.dx, deck.dy,
                                 quantize=qshape_scale(order))

    p1, (jx, jy, _), _ = fused_push_deposit(p0, ft, live_watermark(p0.w),
                                            **_kw(deck, mode))
    jx, jy = jx.to(cpu), jy.to(cpu)
    zx = torch.zeros_like(jx[:, :, :1])
    zy = torch.zeros_like(jy[:, :1, :])
    divx = (jx - torch.cat([zx, jx[:, :, :-1]], dim=2)) / deck.dx
    divy = (jy - torch.cat([zy, jy[:, :-1, :]], dim=1)) / deck.dy
    r0 = rho(p0)
    res = (rho(p1) - r0) / deck.dt + divx + divy
    return float(res.abs().max()) / (float(r0.abs().max()) / deck.dt)


def _compare(p, ft, counts, kw, label: str) -> float:
    """Run the kernel and its plain version on the same inputs, check they
    agree, and return the largest absolute difference of any output."""
    import torch

    from minipic_torch.ops.advance import advance_kernel, advance_plain

    (pk, jk, dk) = advance_kernel(p, ft, counts, **kw)
    (pp, jp, dp) = advance_plain(p, ft, counts, **kw)
    torch.cuda.synchronize()
    live = p.w > 0
    err = 0.0
    for name, a, b, old in zip(("x", "y", "px", "py", "pz"), pk, pp, p):
        check(bool(torch.isfinite(a[live]).all()), f"{label} {name} not "
              "finite")
        check(torch.equal(a[~live], old[~live]),
              f"{label} {name}: dead slots changed")
        d = (a - b)[live].abs()
        # Same ops on the same card, no contraction: ~bit-equal; hold to
        # the CPU tests' 2e-6.
        check(bool((d <= 2e-6 + 2e-6 * b[live].abs()).all()),
              f"{label} {name}: max diff {float(d.max())}")
        err = max(err, float(d.max()))
    for name, a, b in zip(("jx", "jy", "jz"), jk, jp):
        scale = float(b.abs().max())
        d = (a - b).abs()
        if kw["mode"] == "int8" and name != "jz":
            n_diff = int((d > 0).sum())
            print(f"kernel: {label} {name}: {n_diff} of {d.numel()} cells "
                  f"differ (bound {MAX_INT8_CELLS_DIFFERENT})")
            check(n_diff <= MAX_INT8_CELLS_DIFFERENT,
                  f"{label} {name}: {n_diff} cells differ")
        else:
            # f32 sums of ~3.5e3 terms per cell in two atomic orders,
            # before the prefix sums: 1e-5 of the window's peak.
            check(float(d.max()) <= 1e-5 * scale,
                  f"{label} {name}: {float(d.max())} > 1e-5 * {scale}")
        err = max(err, float(d.max()))
    check(abs(float(dk.max()) - float(dp.max())) <= 1e-6 * float(dp.max()),
          f"{label}: dmax differs")
    return err


def phase_kernel(dev) -> None:
    """Kernel against plain version on the 64-tile subset, both orders and
    both modes, with the int8 continuity residual."""
    from minipic_torch.ops.advance import live_watermark

    for order, mode in ((2, "int8"), (2, "f32"), (1, "int8"), (1, "f32")):
        deck, p, ft = _subset(order, dev)
        label = f"subset o{order} {mode}"
        err = _compare(p, ft, live_watermark(p.w), _kw(deck, mode), label)
        msg = (f"kernel: {label}: {int((p.w > 0).sum())} particles, max abs "
               f"err {err:.3e}")
        if mode == "int8":
            cont = _continuity(deck, p, mode, ft)
            msg += f", continuity residual {cont:.3e} of scale"
            check(cont < 3e-6, f"{label} continuity {cont}")
        print(msg)


def _rebin_subset(dev, ppc=None, sigma=0.35, seed=21):
    """64 tiles of the headline tile shape (27136 slots) with thermal
    particles displaced by a Gaussian of `sigma` cells clipped at 2 cells:
    stale buckets, ~7% of the particles off their tile at 0.35, about the
    main path's share at its drift trigger.  `ppc` raises the load (381
    per cell in the headline) for a crowded state."""
    import dataclasses

    import torch

    from minipic_torch import headline
    from minipic_torch.particles.species import load_species
    from minipic_torch.simulation import bucket_capacity

    deck = headline.headline_deck(grid=64)
    check(deck.tiling.num_tiles == SUBSET_TILES, "subset tiling")
    cap = bucket_capacity(deck)
    spec = deck.species[0]
    if ppc is not None:
        spec = dataclasses.replace(spec, ppc=ppc)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = load_species(spec, deck.domain, deck.tiling, cap, gen,
                     torch.float32, dev)
    live = p.w > 0

    def shifted(a, n):
        d = torch.randn(a.shape, generator=gen, device=dev) * sigma
        v = torch.remainder(a + torch.clamp(d, -2.0, 2.0), n)
        return torch.where(live, torch.where(v >= n, v - n, v), a)

    return deck, cap, p._replace(x=shifted(p.x, deck.nx),
                                 y=shifted(p.y, deck.ny))


def _same(a, b, label: str) -> float:
    """Check two particle states (or tensors) are equal slot for slot;
    returns the largest absolute difference (0.0)."""
    import torch

    pairs = (zip(("x", "y", "px", "py", "pz", "w"), a, b)
             if isinstance(a, tuple) else [("", a, b)])
    err = 0.0
    for name, u, v in pairs:
        err = max(err, float((u.double() - v.double()).abs().max())
                  if u.numel() else 0.0)
        check(torch.equal(u, v), f"{label}: {name} differs (max {err})")
    return err


def _clone(p):
    return type(p)(*(a.clone() for a in p))


def phase_rebin_kernels(dev) -> None:
    """Each re-bin kernel against its plain version on the 64-tile subset,
    then the whole deal route on a crowded subset, where the defrag is the
    kernel that runs."""
    import torch

    from minipic_torch.ops import rebin as rb
    from minipic_torch.particles.binning import rebin_auto

    deck, cap, p = _rebin_subset(dev)
    t = deck.tiling
    grid = dict(tile_cols=t.tile_cols, tile_ny=t.tile_ny, tile_nx=t.tile_nx)
    mc = deck.mover_cap(cap)
    sc = deck.mover_seg_cap(mc)
    nbr = rb.seg_neighbor_table(t.tile_rows, t.tile_cols, dev)
    n_live = int((p.w > 0).sum())
    for label, b_cap, force in (("normal", mc, False),
                                ("pending", 1024, False),
                                ("forced", 1024, True)):
        kw = dict(grid, b_cap=b_cap, force=force)
        got = rb.split_kernel(p, **kw)
        want = rb.split_buckets_plain(p, **kw)
        _same(got[0], want[0], f"split {label} buckets")
        _same(got[1], want[1], f"split {label} movers")
        _same(got[2], want[2], f"split {label} stay counts")
        _same(got[3], want[3], f"split {label} pending")
        n_mov = int((want[1].w > 0).sum())
        n_pend = int(want[3].sum())
        print(f"kernel: split {label}: {n_live} particles, buffer {b_cap}, "
              f"{n_mov} movers out, {n_pend} "
              f"{'dropped' if force else 'pending'}: equal")
        check((n_pend > 0) == (label != "normal"), f"split {label}: "
              f"{n_pend} pending")

    p1, movers, wm, _ = rb.split_buckets_plain(p, **grid, b_cap=mc)
    far = movers._replace(x=movers.x.clone(), y=movers.y.clone())
    # Tile 9 is row 1, column 1 of the 8x8 tile grid: a mover in column 4
    # is three tiles from home.
    check(float(far.w[9, 0]) > 0, "tile 9 has no mover")
    far.x[9, 0], far.y[9, 0] = 36.5, 12.0
    for label, m, b_seg in (("normal", movers, sc), ("overflow", movers, 256),
                            (">1-hop", far, sc)):
        kw = dict(tile_rows=t.tile_rows, **grid, b_seg=b_seg)
        seg, dropped = rb.segment_kernel(m, **kw)
        seg_p, dropped_p = rb.segment_movers_plain(m, **kw)
        _same(seg, seg_p, f"segment {label}")
        _same(dropped, dropped_p, f"segment {label} dropped")
        print(f"kernel: segment {label}: runs of {b_seg}, "
              f"{int(dropped_p.sum())} dropped: equal")
        check((int(dropped_p.sum()) > 0) == (label != "normal"),
              f"segment {label}: dropped {int(dropped_p.sum())}")

    seg, _ = rb.segment_movers_plain(movers, tile_rows=t.tile_rows, **grid,
                                     b_seg=sc)
    want, want_d = rb.append_segments_plain(p1, seg, wm, nbr, b_seg=sc)
    got = _clone(p1)
    got_d = rb.append_kernel(got, seg, wm, nbr, b_seg=sc)
    _same(got, want, "append")
    _same(got_d, want_d, "append dropped")
    inc = rb.roll_segments(seg, nbr, sc)
    holes = torch.rand(p.w.shape, device=dev) < 0.3
    ridden = p._replace(w=torch.where(holes, torch.zeros_like(p.w), p.w))
    for label, q, merge in (("merge", p1, True), ("holes", ridden, False)):
        want, want_c, want_d = rb.defrag_buckets_plain(
            q, inc if merge else None)
        got = _clone(q)
        got_c, got_d = rb.defrag_kernel(got, seg if merge else None,
                                        nbr if merge else None, b_seg=sc)
        _same(got, want, f"defrag {label}")
        _same(got_c, want_c, f"defrag {label} counts")
        _same(got_d, want_d, f"defrag {label} dropped")
    print(f"kernel: append and defrag (merge, holes): {int(wm.sum())} "
          "stayers: equal")

    # The whole deal route through the kernels against the plain versions
    # on the CPU; the crowded state (ppc 420 in the same buckets) leaves
    # some bucket within 256 slots of its capacity, so the defrag runs.
    for label, q in (("normal", p), ("crowded", _rebin_subset(dev, 420)[2])):
        for k in rb.KERNELS.values():
            k.reset()
        got, dropped, pending = rebin_auto(q, t, mc, seg_cap=sc)
        cpu = type(q)(*(a.cpu() for a in q))
        want, dropped_p, pending_p = rebin_auto(cpu, t, mc, seg_cap=sc)
        _same(type(q)(*(a.cpu() for a in got)), want, f"rebin_auto {label}")
        check(int(dropped) == int(dropped_p)
              and int(pending) == int(pending_p), f"rebin_auto {label} "
              "counts")
        ran = (rb.append_kernel.taken_count(), rb.defrag_kernel.taken_count())
        print(f"kernel: rebin_auto {label}: {int((q.w > 0).sum())} "
              f"particles, dropped {int(dropped)}, pending {int(pending)}, "
              f"append/defrag ran {ran[0]}/{ran[1]}: equal to the CPU")
        check(ran == ((0, 1) if label == "crowded" else (1, 0)),
              f"rebin_auto {label}: append/defrag ran {ran}")


def _small_deck(rebin_mode: str, ppc: int):
    from minipic_torch.core import config as cfg

    return cfg.Deck(
        box_x=3.2, box_y=3.2, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=4,
        species=(cfg.SpeciesSpec("ele", -1.0, 1.0, ppc=ppc, uth=0.1,
                                 ux=0.05, shape_order=2),),
        capacity_headroom=1.1, kchunk=0, deposit="int8",
        rebin_mode=rebin_mode)


def phase_small_step(dev) -> None:
    """Two 32^2 headline-shaped decks stepped on the card (kernels) and on
    the CPU (plain versions) from the same state: the sort route (ppc 8),
    and the deal route (ppc 40: 3072-slot buckets, 512-slot mover buffers,
    256-slot runs)."""
    from minipic_torch import bridge
    from minipic_torch.ops import rebin as rb
    from minipic_torch.simulation import Simulation

    for label, deck in (("sort", _small_deck("sort", 8)),
                        ("deal", _small_deck("auto", 40))):
        cpu = Simulation(deck, seed=1, device="cpu")
        gpu = Simulation(deck, seed=1, device=dev)
        check(gpu.backend == "cuda", "small deck did not take the CUDA "
              "backend")
        gpu.state = bridge.sim_state_from_numpy(
            bridge.sim_state_to_numpy(cpu.state), dev)
        rb.split_kernel.reset()
        rebins = 0
        for i in range(30):
            dc, dg = cpu.step(), gpu.step()
            fe = (float(dg.field_energy), float(dc.field_energy))
            ke = (float(dg.kinetic_energy[0]), float(dc.kinetic_energy[0]))
            # The CPU tests' bars against JAX (test_torch_step.py).
            check(abs(fe[0] - fe[1]) <= 1e-4 * abs(fe[1]) + 1e-12,
                  f"small {label} step {i}: field energy {fe}")
            check(abs(ke[0] - ke[1]) <= 1e-5 * abs(ke[1]),
                  f"small {label} step {i}: kinetic energy {ke}")
            check(int(dg.overflow) == 0, f"small {label} step {i}: overflow")
            rg = float(gpu.state.drift) == 0.0
            check(rg == (float(cpu.state.drift) == 0.0),
                  f"small {label} step {i}: re-bin steps differ")
            rebins += rg
        check(rebins >= 1, f"small {label} deck never re-binned")
        split = rb.split_kernel.launches
        check(split == (rebins if label == "deal" else 0),
              f"small {label}: {split} split launches, {rebins} re-bins")
        print(f"small step: {label} route, 30 steps at 32^2 on the card "
              f"match the CPU (field energy {fe[0]:.6e} vs {fe[1]:.6e}, "
              f"{rebins} re-bins, {split} split launches)")


def _run(sim, steps: int, card: str, label: str, force_at=None):
    """Step `sim` `steps` times, timing each step; returns (per-step ms of
    advance-only and of re-bin steps, overflow, live before/after, relative
    energy change, peak memory GB)."""
    import torch

    from minipic_torch.core.state import field_energy, kinetic_energy
    from minipic_torch.headline import _force_rebin

    deck = sim.deck
    p0 = sim.state.species[0]
    n_live = int((p0.w > 0).sum())
    e0 = (float(field_energy(sim.state.fields, deck.dx, deck.dy))
          + float(kinetic_energy(p0, deck.species[0].mass)))
    overflow = torch.zeros((), dtype=torch.int32, device=p0.x.device)
    del p0  # would hold the first state's buckets through the run
    torch.cuda.reset_peak_memory_stats()
    adv_ms, rebin_ms = [], []
    for i in range(steps):
        if i == force_at:
            _force_rebin(sim)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        diag = sim.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - ts) * 1e3
        overflow += diag.overflow
        (rebin_ms if float(sim.state.drift) == 0.0 else adv_ms).append(ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(bool(torch.isfinite(c).all()) for c in sim.state.fields),
          f"{label}: fields not finite")
    p = sim.state.species[0]
    check(all(bool(torch.isfinite(a).all()) for a in p),
          f"{label}: particles not finite")
    e1 = float(diag.field_energy) + float(diag.kinetic_energy.sum())
    rel = abs(e1 - e0) / e0
    n_after = int((p.w > 0).sum())
    total_s = (sum(adv_ms) + sum(rebin_ms)) / 1e3
    adv_sorted = sorted(adv_ms)
    print(f"{label}: {steps} steps, re-bins {len(rebin_ms)}, overflow "
          f"{int(overflow)}, live {n_after} (was {n_live}), energy "
          f"{e0:.9e} -> {e1:.9e} (rel change {rel:.3e})")
    print(f"{label}: ms/step {1e3 * total_s / steps:.3f} mean; "
          f"advance-only steps median {statistics.median(adv_ms):.3f}, p80 "
          f"{adv_sorted[int(0.8 * len(adv_sorted))]:.3f} over "
          f"{len(adv_ms)}; re-bin steps "
          f"{', '.join(f'{m:.3f}' for m in rebin_ms)}; pushes/s "
          f"{n_live * steps / total_s:.4e}; peak memory "
          f"{peak_gb:.2f} GB [{card}]")
    check(len(rebin_ms) >= 1, f"{label}: no re-bin")
    check(int(overflow) == 0, f"{label}: overflow {int(overflow)}")
    check(n_after == n_live, f"{label}: live count {n_live} -> {n_after}")
    check(rel < 1e-3, f"{label}: energy changed by {rel:.3e}")
    return rebin_ms


def phase_main(dev, card: str) -> dict:
    """The headline deck as bench.py builds it, on the card; returns each
    kernel's numbers for the JSON line: launches in the run, and error
    and times at its shape."""
    import torch

    from minipic_torch import headline
    from minipic_torch.ops import rebin as rb
    from minipic_torch.ops.advance import advance_kernel
    from minipic_torch.simulation import Simulation

    deck = headline.headline_deck()
    check(deck.rebin_mode == "auto", "headline deck is not bench.py's")
    t0 = time.perf_counter()
    sim = Simulation(deck, seed=0, device=dev)
    torch.cuda.synchronize()
    p0 = sim.state.species[0]
    print(f"main: {int((p0.w > 0).sum())} particles, buckets "
          f"{tuple(p0.x.shape)}, {deck.nx}^2, TSC, int8, deal-route re-bin; "
          f"loaded in {time.perf_counter() - t0:.2f} s")
    del p0
    advance_kernel.launches = 0
    for k in rb.KERNELS.values():
        k.reset()
    rebin_ms = _run(sim, MAIN_STEPS, card, "main")
    launches = {"advance": advance_kernel.launches,
                **{n: k.launches for n, k in rb.KERNELS.items()}}
    ran = (rb.append_kernel.taken_count(), rb.defrag_kernel.taken_count())
    print(f"main: launches {launches}; append/defrag ran {ran[0]}/{ran[1]}")
    check(launches["advance"] == MAIN_STEPS, "advance launches")
    # A re-bin that left movers pending keeps the drift budget, so it is
    # not among the re-bin steps: every split must have reset it.
    for name in ("split", "segment", "append", "defrag"):
        check(launches[name] == len(rebin_ms), f"{launches[name]} {name} "
              f"launches for {len(rebin_ms)} re-bins (pending left?)")
    check(sum(ran) == len(rebin_ms), f"append/defrag ran {ran}")

    # Each kernel against its plain version on the main path's own final
    # state, then each one's time at full size.  These launches come after
    # the counts were read.
    from minipic_torch.fields.halo import pad_fields_periodic
    from minipic_torch.fields.tiles import extract_field_tiles
    from minipic_torch.ops.advance import advance_plain, live_watermark
    from minipic_torch.particles.binning import rebin, rebin_auto

    fields = sim.state.fields
    p = sim.state.species[0]
    t = deck.tiling
    numbers = {}
    ft = extract_field_tiles(pad_fields_periodic(fields, deck.guard),
                             t.tile_rows, t.tile_cols, t.tile_ny, t.tile_nx,
                             deck.guard)
    counts = live_watermark(p.w)
    kw = _kw(deck, "int8")
    err = _compare(p, ft, counts, kw, "main-path shape o2 int8")
    numbers["advance"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: advance_kernel(p, ft, counts, **kw), 5),
        plain_ms=cuda_ms(lambda: advance_plain(p, ft, counts, **kw), 2))
    del ft

    cap = p.capacity
    mc = deck.mover_cap(cap)
    sc = deck.mover_seg_cap(mc)
    grid = dict(tile_cols=t.tile_cols, tile_ny=t.tile_ny, tile_nx=t.tile_nx)
    skw = dict(grid, b_cap=mc)
    got = rb.split_kernel(p, **skw)
    want = rb.split_buckets_plain(p, **skw)
    err = max(_same(a, b, f"main split {i}")
              for i, (a, b) in enumerate(zip(got, want)))
    numbers["split"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: rb.split_kernel(p, **skw), 3),
        plain_ms=cuda_ms(lambda: rb.split_buckets_plain(p, **skw), 1))
    p1, movers, wm, pending = got
    del want
    gkw = dict(tile_rows=t.tile_rows, **grid, b_seg=sc)
    seg, sd = rb.segment_kernel(movers, **gkw)
    seg_p, sd_p = rb.segment_movers_plain(movers, **gkw)
    err = max(_same(seg, seg_p, "main segment"),
              _same(sd, sd_p, "main segment dropped"))
    numbers["segment"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: rb.segment_kernel(movers, **gkw), 3),
        plain_ms=cuda_ms(lambda: rb.segment_movers_plain(movers, **gkw), 1))
    del seg_p
    nbr = rb.seg_neighbor_table(t.tile_rows, t.tile_cols, dev)
    want, want_d = rb.append_segments_plain(p1, seg, wm, nbr, b_seg=sc)
    q = _clone(p1)
    got_d = rb.append_kernel(q, seg, wm, nbr, b_seg=sc)
    err = max(_same(q, want, "main append"),
              _same(got_d, want_d, "main append dropped"))
    # The append is idempotent on its own output (same runs, same
    # watermarks), so repeated launches time it fairly.
    numbers["append"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: rb.append_kernel(q, seg, wm, nbr, b_seg=sc), 3),
        plain_ms=cuda_ms(lambda: rb.append_segments_plain(
            p1, seg, wm, nbr, b_seg=sc), 1))
    del want, q
    inc = rb.roll_segments(seg, nbr, sc)
    want, want_c, want_d = rb.defrag_buckets_plain(p1, inc)
    q = _clone(p1)
    got_c, got_d = rb.defrag_kernel(q, seg, nbr, b_seg=sc)
    err = max(_same(q, want, "main defrag"),
              _same(got_c, want_c, "main defrag counts"),
              _same(got_d, want_d, "main defrag dropped"))
    # Timed on a copy of the split buckets per launch: a second merge
    # into its own output would not be the same work.
    qs = [_clone(p1) for _ in range(3)]
    it = iter(qs)
    numbers["defrag"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: rb.defrag_kernel(next(it), seg, nbr, b_seg=sc), 2,
                   warm=1),
        plain_ms=cuda_ms(lambda: rb.defrag_buckets_plain(p1, inc), 1))
    del want, q, qs, inc
    auto_ms = cuda_ms(lambda: rebin_auto(p, t, mc, seg_cap=sc), 3)
    sort_ms = cuda_ms(lambda: rebin(p, t), 3)
    for name, v in numbers.items():
        print(f"main: {name} at the main path's shape: kernel "
              f"{v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, max abs err "
              f"{v['max_abs_err']:.3e} [{card}]")
    print(f"main: advance kernel {numbers['advance']['ms']:.3f} ms = "
          f"{int((p.w > 0).sum()) / (numbers['advance']['ms'] / 1e3):.4e} "
          f"pushes/s alone; deal-route re-bin (rebin_auto) {auto_ms:.3f} ms, "
          f"sort re-bin {sort_ms:.3f} ms; split buffer {mc}, runs {sc}, "
          f"{int(pending.sum())} pending [{card}]")
    return {n: dict(launches=launches[n], **v) for n, v in numbers.items()}


def phase_sort(dev, card: str) -> None:
    """The sort route, still driven: the headline deck with
    rebin_mode="sort", SORT_STEPS steps, a re-bin forced half way."""
    import torch

    from minipic_torch import headline
    from minipic_torch.ops import rebin as rb
    from minipic_torch.ops.advance import advance_kernel
    from minipic_torch.simulation import Simulation

    sim = Simulation(headline.headline_deck(rebin_mode="sort"), seed=0,
                     device=dev)
    torch.cuda.synchronize()
    advance_kernel.launches = 0
    rb.split_kernel.reset()
    _run(sim, SORT_STEPS, card, "sort", force_at=SORT_STEPS // 2)
    check(advance_kernel.launches == SORT_STEPS, "sort: advance launches")
    check(rb.split_kernel.launches == 0, "sort: the deal route ran")


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(ROOT))
    try:
        import minipic_torch  # noqa: F401
    except ImportError as e:
        fail(f"the minipic_torch package is not beside this script ({e})")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    phase_build()
    phase_kernel(dev)
    phase_rebin_kernels(dev)
    phase_small_step(dev)
    numbers = phase_main(dev, card)
    torch.cuda.empty_cache()
    phase_sort(dev, card)
    print(card)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1], **numbers[name])
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
