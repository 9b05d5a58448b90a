#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``minipic_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing what it found; any failure exits non-zero:

1. build: compiles the advance kernel (csrc/advance.cu) from this checkout;
2. kernel: the kernel against its plain torch version on the card, on 64
   tiles of the headline tile shape (8x8, guard 4, 27136 slots, thermal
   particles, non-zero fields) in int8 and f32 modes, TSC and CIC; then a
   small periodic deck stepped on the card against the same state stepped
   on the CPU;
3. main path: bench.py's headline deck (1e8 particles, 512^2, TSC, int8,
   whole-bucket chunks) with ``rebin_mode="sort"``, 60 ``Simulation.step``
   calls on the card; then the kernel against its plain version on the
   run's final state, at the main path's shapes, and each one's time.

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
SUBSET_TILES = 64
KERNEL_SOURCE = "minipic_torch/csrc/advance.cu"
KERNEL_REPLACES = "minipic_tpu/ops/pallas/ppd_kernel.py:1187"
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
    from minipic_torch.ops._build import build_advance

    built = build_advance()
    print(f"build: {KERNEL_SOURCE} -> {built.path.relative_to(ROOT)} in "
          f"{built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: ptxas: {line.strip()}")


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


def phase_small_step(dev) -> None:
    """A 32^2 headline-shaped deck stepped on the card (kernel) and on the
    CPU (plain version) from the same state."""
    import torch

    from minipic_torch import bridge
    from minipic_torch.core import config as cfg
    from minipic_torch.simulation import Simulation

    deck = cfg.Deck(
        box_x=3.2, box_y=3.2, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=4,
        species=(cfg.SpeciesSpec("ele", -1.0, 1.0, ppc=8, uth=0.1, ux=0.05,
                                 shape_order=2),),
        capacity_headroom=1.1, kchunk=0, deposit="int8", rebin_mode="sort")
    cpu = Simulation(deck, seed=1, device="cpu")
    gpu = Simulation(deck, seed=1, device=dev)
    check(gpu.backend == "cuda", "small deck did not take the CUDA backend")
    gpu.state = bridge.sim_state_from_numpy(
        bridge.sim_state_to_numpy(cpu.state), dev)
    rebins = 0
    for i in range(30):
        dc, dg = cpu.step(), gpu.step()
        fe = (float(dg.field_energy), float(dc.field_energy))
        ke = (float(dg.kinetic_energy[0]), float(dc.kinetic_energy[0]))
        # The CPU tests' bars against JAX (test_torch_step.py).
        check(abs(fe[0] - fe[1]) <= 1e-4 * abs(fe[1]) + 1e-12,
              f"small step {i}: field energy {fe}")
        check(abs(ke[0] - ke[1]) <= 1e-5 * abs(ke[1]),
              f"small step {i}: kinetic energy {ke}")
        check(int(dg.overflow) == 0, f"small step {i}: overflow")
        rg = float(gpu.state.drift) == 0.0
        check(rg == (float(cpu.state.drift) == 0.0),
              f"small step {i}: re-bin steps differ")
        rebins += rg
    check(rebins >= 1, "small deck never re-binned")
    print(f"small step: 30 steps at 32^2 on the card match the CPU "
          f"(field energy {fe[0]:.6e} vs {fe[1]:.6e}, {rebins} re-bins)")


def phase_main(dev, card: str) -> dict:
    """The headline deck on the card; returns the kernel's numbers for the
    JSON line: launches in the run, and error and times at its shape."""
    import torch

    from minipic_torch import headline
    from minipic_torch.core.state import field_energy, kinetic_energy
    from minipic_torch.ops.advance import advance_kernel
    from minipic_torch.simulation import Simulation

    deck = headline.headline_deck()
    t0 = time.perf_counter()
    sim = Simulation(deck, seed=0, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    p0 = sim.state.species[0]
    n_live = int((p0.w > 0).sum())
    e0 = (float(field_energy(sim.state.fields, deck.dx, deck.dy))
          + float(kinetic_energy(p0, deck.species[0].mass)))
    print(f"main: {n_live} particles, buckets {tuple(p0.x.shape)}, "
          f"{deck.nx}^2, TSC, int8, sort re-bin; loaded in {load_s:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    adv_ms, rebin_ms = [], []
    advance_kernel.launches = 0
    for _ in range(MAIN_STEPS):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        diag = sim.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - ts) * 1e3
        overflow += diag.overflow
        (rebin_ms if float(sim.state.drift) == 0.0 else adv_ms).append(ms)
    launches = advance_kernel.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fields = sim.state.fields
    check(all(bool(torch.isfinite(c).all()) for c in fields),
          "fields not finite")
    p = sim.state.species[0]
    check(all(bool(torch.isfinite(a).all()) for a in p), "particles not "
          "finite")
    e1 = float(diag.field_energy) + float(diag.kinetic_energy.sum())
    rel = abs(e1 - e0) / e0
    n_after = int((p.w > 0).sum())
    total_s = (sum(adv_ms) + sum(rebin_ms)) / 1e3
    print(f"main: {MAIN_STEPS} steps, advance launches {launches}, "
          f"re-bins {len(rebin_ms)}, overflow {int(overflow)}, live "
          f"{n_after} (was {n_live}), energy {e0:.9e} -> {e1:.9e} "
          f"(rel change {rel:.3e})")
    adv_sorted = sorted(adv_ms)
    print(f"main: ms/step {1e3 * total_s / MAIN_STEPS:.3f} mean; "
          f"advance-only steps median {statistics.median(adv_ms):.3f}, p80 "
          f"{adv_sorted[int(0.8 * len(adv_sorted))]:.3f} over "
          f"{len(adv_ms)}; re-bin steps "
          f"{', '.join(f'{m:.3f}' for m in rebin_ms)}; pushes/s "
          f"{n_live * MAIN_STEPS / total_s:.4e}; peak memory "
          f"{peak_gb:.2f} GB [{card}]")
    check(launches == MAIN_STEPS, f"{launches} launches for {MAIN_STEPS} "
          "steps")
    check(len(rebin_ms) >= 1, "no re-bin in the main run")
    check(int(overflow) == 0, f"overflow {int(overflow)}")
    check(n_after == n_live, f"live count {n_live} -> {n_after}")
    check(rel < 1e-3, f"energy changed by {rel:.3e}")

    # The kernel against its plain version on the main path's own final
    # state, then each layer's time at full size.  These launches come
    # after the count was read.
    from minipic_torch.fields.halo import pad_fields_periodic
    from minipic_torch.fields.tiles import extract_field_tiles
    from minipic_torch.ops.advance import advance_plain, live_watermark
    from minipic_torch.particles.binning import rebin

    t = deck.tiling
    ft = extract_field_tiles(pad_fields_periodic(fields, deck.guard),
                             t.tile_rows, t.tile_cols, t.tile_ny, t.tile_nx,
                             deck.guard)
    counts = live_watermark(p.w)
    kw = _kw(deck, "int8")
    err = _compare(p, ft, counts, kw, "main-path shape o2 int8")
    kernel_ms = cuda_ms(lambda: advance_kernel(p, ft, counts, **kw), 5)
    plain_ms = cuda_ms(lambda: advance_plain(p, ft, counts, **kw), 2)
    rebin_only_ms = cuda_ms(lambda: rebin(p, t), 3)
    print(f"main: advance at {tuple(p.x.shape)}: kernel {kernel_ms:.3f} ms "
          f"({n_live / (kernel_ms / 1e3):.4e} pushes/s alone), plain "
          f"{plain_ms:.3f} ms, max abs err {err:.3e}; sort re-bin "
          f"{rebin_only_ms:.3f} ms [{card}]")
    return dict(launches=launches, max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms)


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
    phase_small_step(dev)
    numbers = phase_main(dev, card)
    print(card)
    print(json.dumps({"kernels": [dict(
        name="advance", route="cuda", source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES, **numbers)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
