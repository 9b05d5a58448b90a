#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``minipic_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing what it found; any failure exits non-zero:

1. build: compiles the advance kernel (csrc/advance.cu) and the re-bin
   kernels (csrc/rebin.cu) from this checkout, one nvcc each, at once,
   and prints each kernel's registers, shared memory and spills (ptxas),
   the atomic instructions in each advance kernel's SASS and, per
   instantiation, how many shared compare-and-swap loops
   (``ATOMS.CAST.SPIN``) remain: none where each warp owns its J windows
   (the f32 and f64 deposits' private sets) or keeps its sums in
   registers (the f64 tensor-core products), and how many warps share a
   set of J windows at each deck's window;
2. kernel: the advance kernel against its plain torch version on the card,
   on 64 tiles of the headline tile shape (8x8, guard 4, 27136 slots,
   thermal particles, non-zero fields) in int8, f32 and f64 modes, TSC and
   CIC (f64: positions and momenta within 2 ulp of each channel's scale,
   J within 1e-12 of its peak, continuity under 1e-10 of scale), in three
   layouts: lattice order as loaded (a warp's lanes share few
   bases), displaced particles in shuffled slots, and lattice order with a
   few particles in the window-edge fold (int8 operands past 127), the f32
   and f64 J equal bit for bit across two launches (private J window
   sets, the f64 products' warps summed in order; no atomics); the f32
   and f64 modes at windows too wide for a set
   of J windows per warp (2, 4 and 8 warps to a set), against their plain
   versions; then
   each re-bin kernel against its plain version on 64-tile subsets with
   stale buckets, equal in every channel of every slot: the split
   (normal, pending, forced), the segment (overflow, a >1-hop mover), the
   append, append_runs (also equal to the append, and with empty runs),
   the extract (normal, pending, forced, holes, and a ragged 27099-slot
   bucket unforced and forced) and the defrag (merged, hole-ridden) at the
   headline's tile shape; append_incoming (normal, a tile that does not
   fit, inactive) and the defrag with a dense incoming slab at the physics
   decks' (1536 slots); and ``rebin_auto`` on both routes and
   ``rebin_incremental`` through the kernels against the CPU; then all of
   it again over float64 channels.  Open kernel: the advance in its open
   mode (grid None, the decks with absorbing walls) against its plain
   version at laser_plasma's shape (CIC, 20^2 windows, 1536 slots; f32
   and f64) and laser_wakefield_window's (TSC, 16^2, 512 slots; f32),
   with particles leaving through every wall and
   corner and dead slots: positions and momenta equal, J within 2e-5 of
   its peak; the periodic mode on the same subsets as before; the
   diagnostics kernels (csrc/diag.cu, moments and census) against their
   plain versions at the headline's shape after its first census (4096
   tiles x 40704 slots, 99,876,864 live at the bucket heads, thermal
   momenta in the dead slots too, 512^2 fields) over float32 and float64
   channels: counts and flags exact, sums within 1e-12 of the sum of the
   terms' magnitudes, two launches bit-equal; each one's time beside the
   plain version's and its bound, and the HBM rate it reached;
3. small step: two 32^2 decks stepped on the card (kernels) against the
   same state stepped on the CPU (plain versions): the sort route and the
   deal route (ppc 40, buckets big enough for it);
4. decks: ``two_stream``, ``weibel`` and ``landau`` at their default sizes,
   seeded by their ``seed_state``, stepped on the card and on the CPU from
   one state with a re-bin forced half way (the small-bucket route:
   split, sort of the movers, append_incoming or the defrag); open
   twins: ``reference_pulse`` (64^2), ``laser_plasma`` (64^2, ppc 2) and
   ``laser_wakefield_window`` (64x32, ppc 2, through two window shifts)
   stepped on the card and on the CPU from one state;
5. multi-device kernels and twins (``parallel/``, every shard on this
   card): B1, B2 and B3 in global tile coordinates against their plain
   versions (a shard's block with row0 = col0 = 4, a shard's striped gids;
   B1 in int8 and f32, the segment's movers through every seam); then
   ``ShardedSimulation`` at (2, 2) and (2, 4) and ``BalancedSimulation``
   over 8 shards against ``Simulation`` on the card, 30 steps of
   tests/test_parallel.py:84's deck in f32 (int8, guard 4) and of its
   deal-route variant, field energy within 1e-5
   and kinetic within 1e-6 (the JAX package's bars), live counts exact,
   overflow 0; ``laser_wakefield_window`` cut to 64x32, sharded and striped,
   through two shifts;
6. physics: on the card through ``Simulation.run``, the 10k-step
   two-stream energy acceptance run (``scripts/energy_probe.py``'s deck,
   max |dE|/E0 < 1e-3, overflow 0), ``weibel`` for its full run (in-plane
   B energy grows more than 100x), and ``two_stream`` for its full run;
   every drop counted and followed at once by growth, and printed with
   its step and the stage that dropped.  Open decks at their default
   sizes: ``reference_pulse`` for its 63,639 steps with the mid-y Bz
   lineout history kept on the device (speed within 2e-4 of the report's
   0.99977 c and at most 1.0001 c, the two peaks at t = 500 within 3% of
   0.0833 / 0.0683); ``laser_plasma`` for its sim_time (total energy never
   above 1.01 x its start), then the advance's open mode timed on its
   final state, and for each species the re-bin kernels of the route its
   buckets take there (the electrons' grown buckets the deal route, the
   ions' the small-bucket route), each against its plain version;
   ``laser_wakefield_window`` for its sim_time, timed (shifts on the f32
   schedule; each species' live count after the first full transit, held
   to a tenth of its tile column unless it leaves through the walls),
   then again with its walls, shifts and injections counted on the device
   (every injected weight the profile's at absolute x to 1e-6, the live
   count's books exact: net injection less the kills at each wall);
   f64 runs at full size: the energy acceptance in f64 (the exact f64
   deposit, max |dE|/E0 < 1e-3, overflow 0; the JAX package's CPU f64
   record printed beside it), append_incoming on its final state, and
   ``reference_pulse`` in f64 for its 63,639 steps (the same bars);
7. sort route: the headline deck with ``rebin_mode="sort"``, 20 steps with
   one forced re-bin;
8. load balance: the three ``load_balance_*`` decks at their default
   sizes on the (2, 4) mesh, all eight shards on this card, through the
   simulations' ``run_step``: ``load_balance_stress`` sharded (2 x 99,614,720
   particles, the f32 deposit, the deal route, 282 steps), then B1-B3 timed
   at one shard of its final state against their plain versions;
   ``load_balance_stress_counts`` sharded, striped and through
   ``Simulation`` (282 steps each; the live skew over 1.5 blocked and under
   1.10 striped, tests/test_balanced.py:184-187);
   ``load_balance_bunching`` sharded and striped, cut to 900 of its 3,394
   steps; for each run ms/step, kernel launches, peak memory, overflow
   (each drop followed by growth) and the live count conserved exactly;
9. main path: bench.py's headline deck exactly (1e8 particles, 512^2, TSC,
   int8, whole-bucket chunks, the default deal-route re-bin), 60
   ``Simulation.step`` calls on the card; then each kernel against its plain
   version on the run's final state, at the main path's shapes, and each
   one's time (the advance launched fused, as the step launches it, equal
   bit for bit to the raw launch with the fused epilogue's plain contract
   after it; also on a copy with each bucket's live slots
   shuffled, and in its f32 mode on that state, lattice and shuffled),
   with the whole deal-route re-bin (fused and through
   append_runs: equal) and the sort re-bin; then ``rebin_incremental`` on
   that state; then all of it again for the headline deck in f64 (99.9 M
   particles in double, the advance's f64 mode, the re-bin over float64
   channels), with the f64 advance on a 64-tile subset of its final state
   and its continuity residual there (under 1e-10 of scale);
10. cli: the command line (``minipic_torch.cli.main``, in this process,
   into a git-ignored folder of this checkout that it removes), after
   probing for h5py, matplotlib and the native writer (with neither
   writer the runs take ``--no-save`` and the card's part of a save is
   held to numpy's instead): ``laser_plasma`` in full (1,697 steps) three
   times and once stopped at step 850 and resumed, the resumed run held
   to the uninterrupted runs' spread (bit for bit where they agree), live
   counts and overflow equal, its kernels' launches counted per run;
   ``reference_pulse`` at 450^2 for 2,500 steps at the reference's save
   cadence, three times through the CLI and three through
   ``Simulation.run`` in turn (each run's ms/step), its field energy
   conserved to 1e-4, every run's final fields bit for bit alike and
   those of a run resumed half way;
   ``diag/device.py`` on laser_plasma's final state against the CPU
   (counts exact, float64 weights to 1e-5); ``--sharded`` on
   ``load_balance_stress_counts`` (20 steps), and ``--balanced`` on
   ``load_balance_bunching`` cut to 128^2 stopped half way and resumed,
   held to three straight runs as ``laser_plasma``'s resume is;
11. device time: the launch floor (a one-element ``zero_()``),
   append_incoming on the decks' states, the two copy kernels of the main
   path, and the re-bin kernels on laser_plasma's final state, from one
   torch.profiler run (their wrappers take longer on the host than they
   do on the card); last, since profiling slows what runs after it.

The line before last is a JSON object with, for each kernel, its launches
in the phase that drives it, its error against the plain version, both
times (CUDA events; the profiler's device time for the three appends) and
its bound at the shape timed (the advance's entry also its open mode's
numbers at laser_plasma's final state, under "open"; the re-bin kernels
that laser_plasma's run launched, their launches there and their numbers
at its final state per species, under "laser_plasma"; every kernel's
launches in each of the cli phase's laser_plasma runs, under "cli"; B1-B3
at load_balance_stress's shard, under "sharded"; every kernel's launches in
each load_balance run, under "load_balance"; each kernel's numbers on the
f64 path, under "f64": the f64 headline's launches, error, times and bound
(bytes at 8-byte channels, operations at the card's f64 peak), and
append_incoming's at the f64 energy deck; the advance's f32 mode at the
headline's final state, under "f32"); the last line is
``{"ok": true, "device": {...}}``.  Needs CUDA: without a card it fails
before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_STEPS = 60
SORT_STEPS = 20
SUBSET_TILES = 64
DECK_STEPS = {"two_stream": 30, "weibel": 30, "landau": 10}
ENERGY_STEPS = 10000
ENERGY_EVERY = 200
WEIBEL_EVERY = 5
TWO_STREAM_EVERY = 10
# The open-boundary phases: the decks cut for the open-mode kernel subsets
# (laser_plasma's CIC 20^2 windows of 1536 slots, the window deck's TSC
# 16^2 of 512), the small twins (cut, steps), the pulse's lineouts over
# its span, the sampling of the full runs, and the window deck's steps (0:
# its full sim_time).
OPEN_SUBSETS = {"laser_plasma": dict(nx=64, ny=64),
                "laser_wakefield_window": dict(nx=64, ny=32)}
OPEN_TWINS = {"reference_pulse": (dict(nx=64, ny=64), 200),
              "laser_plasma": (dict(nx=64, ny=64, ppc=2), 30),
              "laser_wakefield_window": (dict(nx=64, ny=32, ppc=2), 47)}
PULSE_SAMPLES = 260
OPEN_ENERGY_EVERY = 25
OPEN_WINDOW_EVERY = 50
OPEN_WINDOW_STEPS = 0
# f32 J of the open mode against its plain version: sums in another order,
# 2e-5 of the window's peak (ROADMAP C).
OPEN_J_TOL = 2e-5
ADVANCE_SOURCE = "minipic_torch/csrc/advance.cu"
REBIN_SOURCE = "minipic_torch/csrc/rebin.cu"
DIAG_SOURCE = "minipic_torch/csrc/diag.cu"
# The headline's buckets after the first census grows them 1.5x, and its
# live particles a bucket (PERF.md section 5).
DIAG_TILES, DIAG_CAP, DIAG_LIVE = 4096, 40704, 24384
# The diagnostics kernels' sums against their plain versions': the same
# float64 terms in another order.
DIAG_RTOL = 1e-12
RK = "minipic_tpu/ops/pallas/rebin_kernels.py"
# name -> (source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "advance": (ADVANCE_SOURCE, "minipic_tpu/ops/pallas/ppd_kernel.py:1187"),
    "split": (REBIN_SOURCE, f"{RK}:719"),
    "segment": (REBIN_SOURCE, f"{RK}:1009"),
    "append": (REBIN_SOURCE, f"{RK}:1457"),
    "defrag": (REBIN_SOURCE, f"{RK}:1201"),
    "append_incoming": (REBIN_SOURCE, f"{RK}:1643"),
    "append_runs": (REBIN_SOURCE, f"{RK}:1589"),
    "extract": (REBIN_SOURCE, f"{RK}:394"),
}
# The card's peaks for the bound (H100 SXM, NVIDIA's data sheet): HBM3 and
# f32 outside the tensor cores.  The f64 rate is taken from the card
# (fp64_ops_per_s).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# FP64 lanes of an SM outside the tensor cores on sm_90 (one FMA, two
# operations, each a clock).
FP64_LANES_PER_SM = 64
# The advance's f32 operations per live particle, counted from
# csrc/advance.cu at TSC: ~100 for the two shape sets, ~110 for the six
# gathers, ~60 for the Boris push and move, ~130 for the Esirkepov terms.
ADVANCE_OPS_PER_PARTICLE = 400
# The headline advance of the kernel before its origins became per-tile
# arrays: the spread of PERF.md's runs at the main path's final state (H100
# 80GB HBM3, 700 W).
PARENT_ADVANCE_MS = (6.17, 6.48)
# The f64 deposit's continuity residual, of scale: exact charge
# conservation to f64 round-off.
F64_CONTINUITY = 1e-10
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


def device_times(jobs) -> list:
    """Mean device time in ms of each job's kernel, from one torch.profiler
    run: for kernels shorter than their wrapper's host time, where CUDA
    events around a loop of calls measure the host.  `jobs` is a list of
    (fn, reps, kernel name or tuple of names); each job runs `reps` times
    in order, and its launches are told from the next job's by their order
    on the stream.
    Call it last: in one process, profiling slows what runs after it, and
    a second profile sees no kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn, _, _ in jobs:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn, reps, _ in jobs:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    out, used = [], set()
    for _, reps, name in jobs:
        names = (name,) if isinstance(name, str) else name
        mine = [e for e in kernels if id(e) not in used
                and any(n in e.name for n in names)]
        check(len(mine) >= reps, f"profiler saw {len(mine)} {name} "
              f"launches for {reps}")
        mine = mine[:reps]
        used.update(id(e) for e in mine)
        out.append(sum(e.time_range.elapsed_us() for e in mine) / reps / 1e3)
    return out


_FP64_OPS_PER_S = []


def fp64_ops_per_s() -> float:
    """The card's f64 peak outside the tensor cores: its SMs
    (``multi_processor_count``) x FP64_LANES_PER_SM x 2 operations x its
    largest SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    if not _FP64_OPS_PER_S:
        import torch

        r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
        check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
        mhz = float(r.stdout.strip().splitlines()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _FP64_OPS_PER_S.append(sms * FP64_LANES_PER_SM * 2 * mhz * 1e6)
        print(f"bound: f64 peak {_FP64_OPS_PER_S[0] / 1e12:.2f} TFLOP/s = "
              f"{sms} SMs x {FP64_LANES_PER_SM} FP64 lanes x 2 x {mhz:g} "
              "MHz (the card's largest SM clock)")
    return _FP64_OPS_PER_S[0]


def bound(nbytes: float, ops: float = 0.0, f64: bool = False) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the f32 peak (`f64`: the card's f64
    peak, fp64_ops_per_s)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / (fp64_ops_per_s() if f64 else F32_OPS_PER_S) * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations",
                library_ms=None)


def _live(p) -> int:
    return int((p.w > 0).sum())


def _sass_shared_atomics(lib) -> dict:
    """{kernel (mangled): how many of each atomic opcode its SASS holds
    (ATOMS.* shared memory, ATOM.* / RED.* generic or global)}, from
    ``cuobjdump -sass`` of the built library."""
    import collections
    import re

    from minipic_torch.ops._build import _nvcc

    tool = Path(_nvcc()).with_name("cuobjdump")
    r = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                       text=True, timeout=300)
    check(r.returncode == 0, f"cuobjdump failed: {r.stderr.strip()[-500:]}")
    out, name = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = collections.Counter()
        elif name is not None:
            out[name].update(re.findall(r"\b(?:ATOMS|ATOM|RED)\.[A-Z0-9_.]+",
                                        line))
    return out


def _advance_instantiation(kernel: str) -> str:
    """A readable name of an advance_kernel instantiation from its mangled
    name (template arguments ORDER, QUANT, NP, PERIODIC, SHARED, R,
    PRODUCTS)."""
    import re

    m = re.search(r"advance_kernelILi(\d)ELb([01])ELi(\d)ELb([01])ELb([01])E"
                  r"([df])Lb([01])EE", kernel)
    if m is None:
        return kernel[:90]
    order, quant, np_, periodic, shared, real, products = m.groups()
    mode = "int8" if quant == "1" else ("f64" if real == "d" else "f32")
    return (f"order {order} {mode}"
            + (f" {np_} column pair{'s' if np_ != '1' else ''}"
               if quant == "1" else "")
            + (" periodic" if periodic == "1" else " open")
            + ("" if quant == "1" else
               " tensor-core products" if products == "1" else
               (" shared J sets" if shared == "1" else " private J sets")))


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
            if any(k in line for k in ("Function properties", "registers",
                                       "spill")):
                print(f"build: ptxas: {line.strip()}")
    print(f"build: {len(built)} libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    # Shared-memory atomics as compiled: a shared float or double atomicAdd
    # is a compare-and-swap loop (ATOMS.CAST.SPIN) on this target.  The
    # f32 and f64 deposits into private J sets, and the f64 tensor-core
    # products, add without atomics; the shared sets of wide windows keep
    # them.
    for kernel, ops in _sass_shared_atomics(built["advance.cu"].path).items():
        name = _advance_instantiation(kernel)
        cas = sum(n for op, n in ops.items()
                  if op.startswith("ATOMS.CAST.SPIN"))
        print(f"build: SASS advance {name}: atomics {dict(sorted(ops.items()))}"
              f"; shared compare-and-swap loops: {cas or 'none'}")
        if "private J sets" in name or "tensor-core products" in name:
            check(cas == 0, f"{name}: {cas} ATOMS.CAST.SPIN in the deposit "
                  "into private J windows")
    from minipic_torch.decks import standard
    from minipic_torch.headline import headline_deck
    from minipic_torch.ops.advance import (f64_products, kernel_smem_bytes,
                                           window_warps)

    for name in ["headline", *standard.CASES]:
        deck = headline_deck() if name == "headline" else \
            standard.make(name).deck
        nyg, nxg = deck.tile_ny + 2 * deck.guard, deck.tile_nx + 2 * deck.guard
        sets = ", ".join(
            f"{mode} "
            + ("tensor-core products" if f64_products(nyg, nxg, mode)
               else str(window_warps(nyg, nxg, mode)))
            + f" ({kernel_smem_bytes(nyg, nxg, mode)} bytes a block)"
            for mode in ("f32", "f64"))
        print(f"build: {name} window {nyg}x{nxg}: warps to a set of J "
              f"windows {sets}")
    from minipic_torch.ops.rebin import extract_smem_bytes

    print("build: extract_kernel: dynamic shared memory "
          f"{extract_smem_bytes(27136)} bytes a block at the headline's "
          "27136-slot buckets (ballot words and per-warp totals)")


def _shuffle_slots(p, counts, gen):
    """`p` with each tile's slots below its watermark `counts` in a random
    order; the slots past it stay where they are."""
    import torch

    T, cap = p.x.shape
    slot = torch.arange(cap, device=p.x.device)[None, :]
    keys = torch.where(slot < counts[:, None],
                       torch.rand((T, cap), generator=gen,
                                  device=p.x.device),
                       2.0 + slot / cap)
    perm = torch.argsort(keys, dim=1)
    return type(p)(*(torch.gather(a, 1, perm) for a in p))


SUBSET_LAYOUTS = ("lattice", "shuffled", "edge")


def _subset(order: int, dev, layout: str = "shuffled", dtype=None):
    """64 tiles of the headline tile shape with thermal particles and
    smooth fields, in float32 (or `dtype`: the same values).  `layout`:
    "lattice" as loaded (each cell's particles in consecutive slots);
    "shuffled": displaced up to 1 cell off their tiles (stale buckets),
    each bucket's slots in random order; "edge": lattice order, with
    every 97th particle moved 3.9-4.3 cells below and left of its tile and
    every 89th 3.1-3.4 cells above and right of it, so that their centre
    cells are the window's edge rows and columns, where the edge fold
    lifts TSC's int8 operands past 127 (the scatter route)."""
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
    if layout == "shuffled":
        shift = [torch.rand(p.x.shape, generator=gen, device=dev) * 2.0
                 - 1.0 for _ in range(2)]
        x = p.x + shift[0]
        y = p.y + shift[1]
    elif layout == "edge":
        s = torch.arange(cap, device=dev)[None, :]
        tid = torch.arange(t.num_tiles, device=dev)[:, None]
        ox = (tid % t.tile_cols * t.tile_nx).float()
        oy = (tid // t.tile_cols * t.tile_ny).float()
        low, high = s % 97 == 0, (s % 89 == 0) & (s % 97 != 0)
        x = torch.where(low, ox - 4.3 + 0.4 * (p.x % 1), p.x)
        y = torch.where(low, oy - 4.3 + 0.4 * (p.y % 1), p.y)
        x = torch.where(high, ox + t.tile_nx + 3.1 + 0.3 * (p.x % 1), x)
        y = torch.where(high, oy + t.tile_ny + 3.1 + 0.3 * (p.y % 1), y)
    else:
        check(layout == "lattice", f"subset layout {layout}")
        x, y = p.x, p.y
    x = torch.where(live, torch.remainder(x, deck.nx), p.x)
    y = torch.where(live, torch.remainder(y, deck.ny), p.y)
    x = torch.where(x >= deck.nx, x - deck.nx, x)
    y = torch.where(y >= deck.ny, y - deck.ny, y)
    p = p._replace(x=x, y=y)
    if layout == "shuffled":
        p = _shuffle_slots(p, (live.sum(1)).to(torch.int32), gen)
    j = torch.arange(deck.ny, device=dev, dtype=torch.float32)[:, None]
    i = torch.arange(deck.nx, device=dev, dtype=torch.float32)[None, :]
    k = 2 * torch.pi / deck.nx
    f = FieldState(*(0.05 * torch.sin(k * ((c + 1) * i + (2 - c) * j) + c)
                     for c in range(6)))
    ft = extract_field_tiles(pad_fields_periodic(f, deck.guard), t.tile_rows,
                             t.tile_cols, t.tile_ny, t.tile_nx, deck.guard)
    if dtype is not None:
        p = type(p)(*(a.to(dtype) for a in p))
        ft = type(ft)(*(a.to(dtype) for a in ft))
    return deck, p, ft


def _kw(deck, mode, dev, origins=None):
    """The advance's arguments for deck's first species in `mode`, on its
    whole tile grid, or on the tiles whose origins are `origins`."""
    from minipic_torch.simulation import tile_origins

    t = deck.tiling
    return dict(qm=-1.0, q=-1.0, order=deck.species[0].shape_order,
                tile_ny=t.tile_ny, tile_nx=t.tile_nx,
                origins=(tile_origins(t, dev) if origins is None
                         else origins), g=deck.guard,
                dt=deck.dt, dx=deck.dx, dy=deck.dy, grid=(deck.nx, deck.ny),
                mode=mode)


def _continuity(deck, p0, mode, ft, origins=None):
    """max |(rho1 - rho0)/dt + div J| / (max|rho0|/dt) of the kernel's own
    output, with rho from the shapes the deposit used: quantized in int8
    mode, exact in f64 mode.  `origins`: the tiles' origins (int32 [T] on
    the card) when they are not the deck's whole grid.  The dense rho
    diagnostic runs on the CPU, as in the CPU tests, so that the residual
    measures the kernel's J: formed on the card (H100), the f32 matmul over
    a tile's 27136 slots alone left 2.8e-6 of scale."""
    import torch

    from minipic_torch.ops.advance import fused_push_deposit, qshape_scale
    from minipic_torch.particles.deposit import deposit_rho_chunk
    from minipic_torch.simulation import tile_local_coords, tile_origins

    t = deck.tiling
    order = deck.species[0].shape_order
    cpu = torch.device("cpu")
    cpu_origins = (tile_origins(t, cpu) if origins is None
                   else tuple(o.to(cpu) for o in origins))

    def rho(p):
        p = type(p)(*(a.to(cpu) for a in p))
        xi, eta = tile_local_coords(p.x, p.y, cpu_origins, t.tile_nx,
                                    t.tile_ny, (deck.nx, deck.ny))
        return deposit_rho_chunk(
            xi, eta, -p.w, t.tile_ny, t.tile_nx, deck.guard, order, deck.dx,
            deck.dy, quantize=qshape_scale(order) if mode == "int8" else 0.0)

    p1, (jx, jy, _), _ = fused_push_deposit(
        p0, ft, **_kw(deck, mode, p0.x.device, origins))
    jx, jy = jx.to(cpu), jy.to(cpu)
    zx = torch.zeros_like(jx[:, :, :1])
    zy = torch.zeros_like(jy[:, :1, :])
    divx = (jx - torch.cat([zx, jx[:, :, :-1]], dim=2)) / deck.dx
    divy = (jy - torch.cat([zy, jy[:, :-1, :]], dim=1)) / deck.dy
    r0 = rho(p0)
    res = (rho(p1) - r0) / deck.dt + divx + divy
    return float(res.abs().max()) / (float(r0.abs().max()) / deck.dt)


def _ulps(a, b) -> float:
    """max |a - b| in ulps of the channel's scale (the spacing of its type
    at max |b|): the push's sums cancel near zero, so a value carries its
    operands' error."""
    import torch

    if not a.numel():
        return 0.0
    return float((a - b).abs().max() / torch.finfo(b.dtype).eps
                 / b.abs().max().clamp(min=1e-300))


# f64 mode against its plain version: positions and momenta within this
# many ulps of each channel's scale (the same ops in the same order but the
# gather's, no contraction), J within F64_J_TOL of its window's peak
# (sums in another order).
F64_ULPS = 2
F64_J_TOL = 1e-12


def _compare(p, ft, counts, kw, label: str) -> float:
    """Run the kernel and its plain version on the same inputs, check they
    agree, and return the largest absolute difference of any output."""
    import torch

    from minipic_torch.ops.advance import advance_kernel, advance_plain

    (pk, jk, dk) = advance_kernel(p, ft, counts, **kw)
    (pp, jp, dp) = advance_plain(p, ft, counts, **kw)
    torch.cuda.synchronize()
    live = p.w > 0
    f64 = kw["mode"] == "f64"
    err = 0.0
    for name, a, b, old in zip(("x", "y", "px", "py", "pz"), pk, pp, p):
        check(bool(torch.isfinite(a[live]).all()), f"{label} {name} not "
              "finite")
        check(torch.equal(a[~live], old[~live]),
              f"{label} {name}: dead slots changed")
        d = (a - b)[live].abs()
        if f64:
            u = _ulps(a[live], b[live])
            check(u <= F64_ULPS, f"{label} {name}: {u:.2f} ulps of the "
                  f"channel's scale (max diff {float(d.max())})")
        else:
            # Same ops on the same card, no contraction: ~bit-equal; hold
            # to the CPU tests' 2e-6.
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
            # f32 sums of ~3.5e3 terms per cell in two orders, before the
            # prefix sums: 1e-5 of the window's peak.
            tol = F64_J_TOL if f64 else 1e-5
            check(float(d.max()) <= tol * scale,
                  f"{label} {name}: {float(d.max())} > {tol} * {scale}")
        err = max(err, float(d.max()))
    dtol = 1e-12 if f64 else 1e-6
    check(abs(float(dk.max()) - float(dp.max())) <= dtol * float(dp.max()),
          f"{label}: dmax differs")
    return err


def _compare_fused(p, ft, counts, kw, label: str) -> float:
    """B1 fused (the step's advance on the card: its own watermark, the
    prefix sums, then the finish kernel) against B1 raw over `counts` (the
    live watermark) with the plain contract of the fused epilogue after it
    (``minipic_torch.testing.fused_epilogue``): equal bit for bit.  Returns
    the fused call's device ms."""
    import torch

    from minipic_torch.ops.advance import advance_kernel
    from minipic_torch.testing import fused_epilogue

    out, js, d = advance_kernel.fused(p, ft, **kw)
    raw_out, raw_js, raw_d = advance_kernel(p, ft, counts, **kw)
    want_js, want_d = fused_epilogue(raw_js, raw_d, p.w, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("x", "y", "px", "py", "pz"), out, raw_out):
        check(torch.equal(a, b), f"{label} {name}: fused differs from raw")
    for name, a, b in zip(("jx", "jy", "jz"), js, want_js):
        check(torch.equal(a, b), f"{label} {name}: fused differs from the "
              "raw windows' epilogue")
    check(torch.equal(d, want_d), f"{label}: max displacement differs")
    ms = cuda_ms(lambda: advance_kernel.fused(p, ft, **kw), 5)
    print(f"kernel: {label}: fused equals raw and its epilogue bit for bit; "
          f"fused {ms:.3f} ms")
    return ms


def phase_kernel(dev) -> None:
    """Kernel against plain version on the 64-tile subsets of each layout,
    both orders and both modes, with the int8 continuity residual."""
    import itertools

    from minipic_torch.ops.advance import (MODE_DTYPES, kernel_smem_bytes,
                                           live_watermark, window_warps)

    for layout, (order, mode) in itertools.product(
            SUBSET_LAYOUTS, ((2, "int8"), (2, "f32"), (1, "int8"),
                             (1, "f32"), (2, "f64"), (1, "f64"))):
        deck, p, ft = _subset(order, dev, layout, MODE_DTYPES[mode])
        label = f"subset {layout} o{order} {mode}"
        err = _compare(p, ft, live_watermark(p.w), _kw(deck, mode, dev),
                       label)
        msg = (f"kernel: {label}: {int((p.w > 0).sum())} particles, max abs "
               f"err {err:.3e}")
        if mode in ("int8", "f64"):
            cont = _continuity(deck, p, mode, ft)
            bar = 3e-6 if mode == "int8" else F64_CONTINUITY
            msg += f", continuity residual {cont:.3e} of scale (bar {bar})"
            check(cont < bar, f"{label} continuity {cont}")
        if mode != "int8":
            _repeatable(p, ft, _kw(deck, mode, dev), label)
            msg += ", J bit for bit across two launches"
        print(msg)
    for mode, n in WIDE_WINDOWS:
        p, ft, kw = _wide_subset(n, mode, dev)
        w = window_warps(n, n, mode)
        err = _compare(p, ft, live_watermark(p.w), kw,
                       f"wide {n}^2 window {mode}")
        print(f"kernel: {mode} at a {n}x{n} window ({w} warps to a set of J "
              f"windows, {kernel_smem_bytes(n, n, mode)} bytes a block): "
              f"{_live(p)} particles, max abs err {err:.3e}")


# The f32 and f64 modes at windows too wide for a set of J windows per
# warp: (mode, window), taking 2, 4 and 8 warps to a set.
WIDE_WINDOWS = (("f32", 48), ("f32", 60), ("f32", 72), ("f64", 36),
                ("f64", 48), ("f64", 52))


def _wide_subset(n: int, mode: str, dev, g: int = 2, cap: int = 4096,
                 n_live: int = 3000):
    """2x2 tiles of (n - 2g)^2 cells (windows n^2), TSC: n_live thermal
    particles a bucket in lattice order over the tile's cells, displaced
    up to half a cell, and smooth fields, in `mode`'s dtype; with the
    advance's keywords."""
    import torch

    from minipic_torch.core.state import FieldState, ParticleState
    from minipic_torch.ops.advance import MODE_DTYPES
    from minipic_torch.simulation import tile_origins
    from minipic_torch.core.geometry import Tiling

    tile, T = n - 2 * g, 4
    gen = torch.Generator(device=dev).manual_seed(17)
    rnd = lambda: torch.rand((T, cap), generator=gen, device=dev)  # noqa
    s = torch.arange(cap, device=dev)[None, :]
    t = torch.arange(T, device=dev)[:, None]
    cell = (s * tile * tile) // n_live
    x = (t % 2) * tile + cell % tile + rnd() - 0.25
    y = (t // 2) * tile + cell // tile % tile + rnd() - 0.25
    x, y = (torch.remainder(a, 2 * tile) for a in (x, y))
    mom = [torch.randn((T, cap), generator=gen, device=dev) * 0.05
           for _ in range(3)]
    w = (s < n_live).float().expand(T, cap) * 0.004
    p = ParticleState(x, y, *mom, w.contiguous())
    j = torch.arange(2 * tile + 2 * g, device=dev, dtype=torch.float32)
    win = torch.stack([torch.stack([
        0.05 * torch.sin(0.2 * (c + 1) * j[:, None] + 0.1 * (2 - c) * j[None, :]
                         + c + k)
        for k in range(T)]) for c in range(6)])
    ft = FieldState(*(f[:, :n, :n].contiguous() for f in win))
    real = MODE_DTYPES[mode]
    p = type(p)(*(a.to(real) for a in p))
    ft = type(ft)(*(a.to(real) for a in ft))
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=tile, tile_nx=tile,
              origins=tile_origins(Tiling(tile_rows=2, tile_cols=2,
                                          tile_ny=tile, tile_nx=tile), dev),
              g=g, dt=0.035, dx=0.1, dy=0.1, grid=(2 * tile, 2 * tile),
              mode=mode)
    return p, ft, kw


def _repeatable(p, ft, kw, label: str) -> None:
    """Two launches of the f32 / f64 kernel give the same particles and J
    bit for bit: each warp adds to its own J windows without atomics."""
    import torch

    from minipic_torch.ops.advance import advance_kernel, live_watermark

    counts = live_watermark(p.w)
    a = advance_kernel(p, ft, counts, **kw)
    b = advance_kernel(p, ft, counts, **kw)
    for name, u, v in zip(("x", "y", "px", "py", "pz", "jx", "jy", "jz",
                           "dmax"), a[0] + a[1] + (a[2],),
                          b[0] + b[1] + (b[2],)):
        check(torch.equal(u, v), f"{label}: {name} differs between two "
              "launches")


def _rebin_subset(dev, ppc=None, sigma=0.35, seed=21, dtype=None):
    """64 tiles of the headline tile shape (27136 slots) with thermal
    particles displaced by a Gaussian of `sigma` cells clipped at 2 cells:
    stale buckets, ~7% of the particles off their tile at 0.35, about the
    main path's share at its drift trigger.  `ppc` raises the load (381
    per cell in the headline) for a crowded state.  Made in float32;
    `dtype`: the same values in that type."""
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

    p = p._replace(x=shifted(p.x, deck.nx), y=shifted(p.y, deck.ny))
    if dtype is not None:
        p = type(p)(*(a.to(dtype) for a in p))
    return deck, cap, p


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


def phase_rebin_kernels(dev, dtype=None) -> None:
    """Each re-bin kernel against its plain version on the 64-tile subset,
    then the whole deal route on a crowded subset, where the defrag is the
    kernel that runs; float32 channels, or the same states in `dtype`."""
    import torch

    from minipic_torch.ops import rebin as rb
    from minipic_torch.particles.binning import rebin_auto

    deck, cap, p = _rebin_subset(dev, dtype=dtype)
    tag = "" if dtype is None else f" {str(dtype)[6:]}"
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
        print(f"kernel{tag}: split {label}: {n_live} particles, buffer "
              f"{b_cap}, {n_mov} movers out, {n_pend} "
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
        print(f"kernel{tag}: segment {label}: runs of {b_seg}, "
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
    print(f"kernel{tag}: append and defrag (merge, holes): {int(wm.sum())} "
          "stayers: equal")

    # The whole deal route through the kernels against the plain versions
    # on the CPU; the crowded state (ppc 420 in the same buckets) leaves
    # some bucket within 256 slots of its capacity, so the defrag runs.
    crowded = _rebin_subset(dev, 420, dtype=dtype)[2]
    for label, q in (("normal", p), ("crowded", crowded)):
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
        print(f"kernel{tag}: rebin_auto {label}: {int((q.w > 0).sum())} "
              f"particles, dropped {int(dropped)}, pending {int(pending)}, "
              f"append/defrag ran {ran[0]}/{ran[1]}: equal to the CPU")
        check(ran == ((0, 1) if label == "crowded" else (1, 0)),
              f"rebin_auto {label}: append/defrag ran {ran}")


def _physics_subset(dev, ppc=16, sigma=0.5, seed=41, dtype=None):
    """The two_stream deck's 64 tiles (1536-slot buckets, mover buffer
    640) with its right beam displaced by a Gaussian of `sigma` cells
    clipped at 2 cells: stale buckets of the small-bucket route.  `ppc`
    raises the load for a crowded state.  Made in float32; `dtype`: the
    same values in that type."""
    import torch

    from minipic_torch.decks import standard
    from minipic_torch.particles.species import load_species
    from minipic_torch.simulation import bucket_capacity

    deck = standard.make("two_stream").deck
    check(deck.tiling.num_tiles == SUBSET_TILES, "physics subset tiling")
    cap = bucket_capacity(deck)
    spec = dataclasses.replace(deck.species[0], ppc=ppc)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = load_species(spec, deck.domain, deck.tiling, cap, gen,
                     torch.float32, dev)
    live = p.w > 0

    def shifted(a, n):
        d = torch.randn(a.shape, generator=gen, device=dev) * sigma
        v = torch.remainder(a + torch.clamp(d, -2.0, 2.0), n)
        return torch.where(live, torch.where(v >= n, v - n, v), a)

    p = p._replace(x=shifted(p.x, deck.nx), y=shifted(p.y, deck.ny))
    if dtype is not None:
        p = type(p)(*(a.to(dtype) for a in p))
    return deck, cap, p


def phase_rebin_kernels_b6_b8(dev, dtype=None) -> None:
    """append_runs and the extract on the headline's 64-tile subset,
    append_incoming and the dense defrag on the physics decks' tiles, each
    against its plain version; then the small-bucket rebin_auto and
    rebin_incremental through the kernels against the CPU; float32
    channels, or the same states in `dtype`."""
    import torch

    from minipic_torch.ops import rebin as rb
    from minipic_torch.particles.binning import (rebin_auto,
                                                 rebin_incremental,
                                                 route_movers)

    deck, cap, p = _rebin_subset(dev, dtype=dtype)
    tag = "" if dtype is None else f" {str(dtype)[6:]}"
    t = deck.tiling
    grid = dict(tile_cols=t.tile_cols, tile_ny=t.tile_ny, tile_nx=t.tile_nx)
    mc = deck.mover_cap(cap)
    sc = deck.mover_seg_cap(mc)
    nbr = rb.seg_neighbor_table(t.tile_rows, t.tile_cols, dev)
    p1, movers, wm, _ = rb.split_buckets_plain(p, **grid, b_cap=mc)
    seg, _ = rb.segment_movers_plain(movers, tile_rows=t.tile_rows, **grid,
                                     b_seg=sc)
    inc = rb.roll_segments(seg, nbr, sc)
    want, want_d = rb.append_runs_plain(p1, inc, wm, b_seg=sc)
    got = _clone(p1)
    got_d = rb.append_runs_kernel(got, inc, wm, b_seg=sc)
    fused = _clone(p1)
    fused_d = rb.append_kernel(fused, seg, wm, nbr, b_seg=sc)
    _same(got, want, "append_runs")
    _same(got_d, want_d, "append_runs dropped")
    _same(got, fused, "append_runs against the fused append")
    _same(got_d, fused_d, "append_runs dropped against the fused append")
    print(f"kernel{tag}: append_runs: {int((inc.w > 0).sum())} arrivals in "
          f"runs of {sc}: equal to its plain version and to the fused append")
    # The same runs with runs 0, 3 and 7 of every tile emptied: the flat
    # copy steps over them.
    gone = torch.zeros(8, dtype=torch.bool, device=dev)
    gone[[0, 3, 7]] = True
    gone = gone.repeat_interleave(sc)[None, :]
    sparse = type(inc)(*(torch.where(gone, torch.zeros_like(a), a)
                         for a in inc))
    want, want_d = rb.append_runs_plain(p1, sparse, wm, b_seg=sc)
    got = _clone(p1)
    got_d = rb.append_runs_kernel(got, sparse, wm, b_seg=sc)
    _same(got, want, "append_runs with empty runs")
    _same(got_d, want_d, "append_runs with empty runs dropped")
    print(f"kernel{tag}: append_runs with runs 0, 3 and 7 empty: "
          f"{int((sparse.w > 0).sum())} arrivals: equal")

    holes = torch.rand(p.w.shape, device=dev) < 0.3
    ridden = p._replace(w=torch.where(holes, torch.zeros_like(p.w), p.w))
    # 27099 slots: the last ballot word is ragged, and the JAX rule's chunk
    # is the whole bucket, so an unforced tile with movers does not extract
    # (its w is put back).
    ragged = type(p)(*(a[:, :cap - 37].contiguous() for a in p))
    for label, q, b_cap, force, short in (
            ("normal", p, mc, False, False), ("pending", p, 1024, False, True),
            ("forced", p, 1024, True, True), ("holes", ridden, mc, False, False),
            ("ragged", ragged, mc, False, True),
            ("ragged forced", ragged, mc, True, False)):
        kw = dict(grid, b_cap=b_cap, force=force)
        got = rb.extract_kernel(q, **kw)
        want = rb.extract_movers_plain(q, **kw)
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"extract {label} output {i}")
        n_pend = int(want[3].sum())
        print(f"kernel{tag}: extract {label}: buckets {q.x.shape[1]}, buffer "
              f"{b_cap}, {_live(want[1])} movers out, {n_pend} "
              f"{'dropped' if force else 'pending'}: equal")
        check((n_pend > 0) == short, f"extract {label}: {n_pend} not kept")

    sdeck, scap, sp = _physics_subset(dev, dtype=dtype)
    st = sdeck.tiling
    sgrid = dict(tile_cols=st.tile_cols, tile_ny=st.tile_ny,
                 tile_nx=st.tile_nx)
    smc = sdeck.mover_cap(scap)
    sp1, smov, swm, _ = rb.split_buckets_plain(sp, **sgrid, b_cap=smc)
    sinc, _ = route_movers(smov, st, smc)
    n_in = (sinc.w > 0).sum(1, dtype=torch.int32)
    odd = torch.arange(st.num_tiles, device=dev) % 2 == 1
    crowded_wm = torch.where(odd, scap - n_in + 5, swm).to(torch.int32)
    for label, w_m, active in (("normal", swm, True),
                               ("not fitting", crowded_wm, True),
                               ("inactive", swm, False)):
        want, want_d = rb.append_incoming_plain(sp1, sinc, w_m)
        if not active:
            want, want_d = sp1, torch.zeros_like(want_d)
        got = _clone(sp1)
        got_d = rb.append_incoming_kernel(got, sinc, w_m, active=active)
        _same(got, want, f"append_incoming {label}")
        _same(got_d, want_d, f"append_incoming {label} dropped")
        print(f"kernel{tag}: append_incoming {label}: buckets {scap}, "
              f"incoming {smc}, {int(n_in.sum())} arrivals, "
              f"{int(want_d.sum())} dropped: equal")
        check((int(want_d.sum()) > 0) == (label == "not fitting"),
              f"append_incoming {label}: dropped {int(want_d.sum())}")
    _, _, crowd = _physics_subset(dev, ppc=22, dtype=dtype)
    _, cmov, _, _ = rb.split_buckets_plain(crowd, **sgrid, b_cap=smc)
    cinc, _ = route_movers(cmov, st, smc)
    want, want_c, want_d = rb.defrag_buckets_plain(crowd, cinc)
    got = _clone(crowd)
    got_c, got_d = rb.defrag_kernel(got, cinc)
    _same(got, want, "defrag dense")
    _same(got_c, want_c, "defrag dense counts")
    _same(got_d, want_d, "defrag dense dropped")
    check(int(want_d.sum()) > 0, "defrag dense: no census overflow")
    print(f"kernel{tag}: defrag with a dense incoming slab: {_live(crowd)} + "
          f"{_live(cinc)} arrivals, {int(want_d.sum())} dropped: equal")

    for label, q in (("normal", sp), ("crowded", crowd)):
        for k in rb.KERNELS.values():
            k.reset()
        got, dropped, pending = rebin_auto(q, st, smc, seg_cap=512)
        cpu = type(q)(*(a.cpu() for a in q))
        want, dropped_p, pending_p = rebin_auto(cpu, st, smc, seg_cap=512)
        _same(type(q)(*(a.cpu() for a in got)), want,
              f"small rebin_auto {label}")
        check(int(dropped) == int(dropped_p)
              and int(pending) == int(pending_p),
              f"small rebin_auto {label} counts")
        ran = (rb.append_incoming_kernel.taken_count(),
               rb.defrag_kernel.taken_count())
        check(rb.segment_kernel.launches == 0, "small route ran the segment")
        check(ran == ((0, 1) if label == "crowded" else (1, 0)),
              f"small rebin_auto {label}: append_incoming/defrag ran {ran}")
        print(f"kernel{tag}: small-bucket rebin_auto {label}: {_live(q)} "
              f"particles, dropped {int(dropped)}, append_incoming/defrag "
              f"ran {ran[0]}/{ran[1]}: equal to the CPU")
    cpu = type(sp)(*(a.cpu() for a in sp))
    got, dropped, wm_after = rebin_incremental(_clone(sp), st, smc)
    want, dropped_p, wm_p = rebin_incremental(cpu, st, smc)
    _same(type(sp)(*(a.cpu() for a in got)), want, "rebin_incremental")
    check(int(dropped) == int(dropped_p) and int(wm_after) == int(wm_p),
          "rebin_incremental counts")
    print(f"kernel{tag}: rebin_incremental: {_live(sp)} particles, dropped "
          f"{int(dropped)}, max watermark {int(wm_after)}: equal to the CPU")


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
    the CPU (plain versions) from the same state: the sort route (ppc 8)
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
        for k in rb.KERNELS.values():
            k.reset()
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
        app = (rb.append_kernel.launches, rb.append_runs_kernel.launches)
        check(split == (0 if label == "sort" else rebins),
              f"small {label}: {split} split launches, {rebins} re-bins")
        check(app == (split, 0),
              f"small {label}: append/append_runs launches {app}")
        print(f"small step: {label} route, 30 steps at 32^2 on the card "
              f"match the CPU (field energy {fe[0]:.6e} vs {fe[1]:.6e}, "
              f"{rebins} re-bins, {split} split launches, append/"
              f"append_runs launches {app[0]}/{app[1]})")


def _energies(state, deck):
    """(field, kinetic) energy of a state, f64, read to the host."""
    from minipic_torch.core.state import field_energy, kinetic_energy

    ke = sum(float(kinetic_energy(p, s.mass))
             for p, s in zip(state.species, deck.species))
    return float(field_energy(state.fields, deck.dx, deck.dy)), ke


def phase_decks(dev) -> dict:
    """two_stream, weibel and landau from decks.make at their default sizes,
    seeded, stepped on the card and on the CPU from one state; a re-bin is
    forced half way if the drift trigger has not fired.  Returns
    append_incoming's numbers on each deck's final state, with its launches
    in that deck's card run (its device time is left to device_times)."""
    from minipic_torch import bridge
    from minipic_torch.decks import standard
    from minipic_torch.ops import rebin as rb
    from minipic_torch.simulation import Simulation

    numbers = {}
    for name, steps in DECK_STEPS.items():
        case = standard.make(name)
        deck = case.deck
        cpu = Simulation(deck, seed=1, device="cpu")
        cpu.state = case.seed_state(cpu.state, deck)
        gpu = Simulation(deck, seed=1, device=dev)
        gpu.state = bridge.sim_state_from_numpy(
            bridge.sim_state_to_numpy(cpu.state), dev)
        n_live = sum(_live(p) for p in gpu.state.species)
        rebin_steps = []
        for k in rb.KERNELS.values():
            k.reset()
        for i in range(steps):
            if i == steps // 2 and not rebin_steps:
                cpu.force_rebin()
                gpu.force_rebin()
            dc, dg = cpu.step(), gpu.step()
            fe = (float(dg.field_energy), float(dc.field_energy))
            check(abs(fe[0] - fe[1]) <= 1e-4 * abs(fe[1]) + 1e-12,
                  f"{name} step {i}: field energy {fe}")
            # The step twin's 1e-5 per species; the cold ions' energy is
            # ~1e-9 of the total and round-off of the field's push, so it
            # is held to 1e-7 of the total as well.
            kg = dg.kinetic_energy.cpu()
            kc = dc.kinetic_energy
            tol = 1e-5 * kc.abs() + 1e-7 * float(kc.sum())
            check(bool(((kg - kc).abs() <= tol).all()),
                  f"{name} step {i}: kinetic energy {kg} vs {kc}")
            check(int(dg.overflow) == 0 and int(dc.overflow) == 0,
                  f"{name} step {i}: overflow")
            rg = float(gpu.state.drift) == 0.0
            check(rg == (float(cpu.state.drift) == 0.0),
                  f"{name} step {i}: re-bin steps differ")
            if rg:
                rebin_steps.append(i)
        live = sum(_live(p) for p in gpu.state.species)
        check(live == n_live, f"{name}: live {n_live} -> {live}")
        check(len(rebin_steps) >= 1, f"{name}: no re-bin")
        launches = _auto_route_launches(name, small_only=True)
        check(launches["split"] == len(rebin_steps) * len(deck.species),
              f"{name}: split launches {launches['split']}")
        print(f"decks: {name} {deck.nx}x{deck.ny}, {len(deck.species)} "
              f"species, {n_live} particles, buckets "
              f"{gpu.state.species[0].capacity}: {steps} steps on the card "
              f"match the CPU (re-bins at steps {rebin_steps}, field "
              f"energy {fe[0]:.6e} vs {fe[1]:.6e}); {launches}")
        numbers[name] = dict(
            launches=launches["append_incoming"],
            **_route_numbers(gpu.state.species[0], deck)["append_incoming"])
    return numbers


def _auto_route_launches(label: str, small_only: bool) -> dict:
    """The re-bin launches since the counters were reset, checked: each
    species re-bin through rebin_auto launches the split and the defrag
    once, and append_incoming (the small-bucket route) or the segment and
    the append (the deal route, which buckets grown past 8 runs + 256
    slots take); the device flag takes the defrag or the append, and
    append_incoming is taken at least once.  `small_only`: the deal route
    must not have run.  Returns the launches, with the taken counts."""
    from minipic_torch.ops import rebin as rb

    launches = {n: k.launches for n, k in rb.KERNELS.items()}
    split = launches["split"]
    taken = {f"{n}_taken": rb.KERNELS[n].taken_count()
             for n in ("append_incoming", "append", "defrag")}
    check(launches["append_incoming"] + launches["segment"] == split
          and launches["append"] == launches["segment"]
          and launches["defrag"] == split,
          f"{label}: launches {launches}")
    check(taken["append_incoming_taken"] >= 1
          and sum(taken.values()) == split,
          f"{label}: taken {taken} of {split} re-bins")
    check(not small_only or launches["segment"] == 0,
          f"{label}: the deal route ran")
    return dict(launches, **taken)


class _DropSources:
    """Where a run's drops come from: for the run, wraps the stages through
    which rebin_auto drops (the route of the movers, the segment, the
    appends, the defrag) and sums on the device what each dropped and in
    how many tiles (per re-bin); the rest of the overflow is the forced
    split's backlog."""

    STAGES = (("binning", "route_movers", 1), ("rb", "segment_movers", 1),
              ("rb", "append_incoming_", None), ("rb", "append_segments_", None),
              ("rb", "append_runs_", None), ("rb", "defrag_buckets_", 1))

    def __enter__(self):
        from minipic_torch.ops import rebin as rb
        from minipic_torch.particles import binning

        mods = {"binning": binning, "rb": rb}
        self.sums, self.tiles, self._real = {}, {}, []
        for mod, name, idx in self.STAGES:
            real = getattr(mods[mod], name)
            self._real.append((mods[mod], name, real))
            setattr(mods[mod], name, self._wrap(name, real, idx))
        return self

    def _wrap(self, name, real, idx):
        def f(*a, **k):
            out = real(*a, **k)
            d = out if idx is None else out[idx]
            self.sums[name] = self.sums.get(name, 0) + d.sum()
            self.tiles[name] = self.tiles.get(name, 0) + (d > 0).sum()
            return out
        return f

    def __exit__(self, *exc):
        for mod, name, real in self._real:
            setattr(mod, name, real)

    def read(self, overflow: int) -> dict:
        """{stage: (particles, tiles)} of the stages that dropped."""
        out = {n: (int(v), int(self.tiles[n]))
               for n, v in self.sums.items() if int(v)}
        out["split backlog (forced)"] = (
            overflow - sum(n for n, _ in out.values()), None)
        return out


def timed_run(sim, steps, every, sample, label, card, closed=True,
              stages=True):
    """sim.run, timed, with sample(state, step) at step 0 and every
    `every` steps; checks that every re-bin went through the re-bin
    kernels and that each drop was counted and grew the buckets at once
    (the JAX package's policy: a second drop needs a tile fuller than
    the grown buckets).  Prints each step that dropped, with the change
    of total energy over that step and which stage dropped
    (``_DropSources``).  `closed`: no particle leaves or enters the box
    (periodic, no window), so every particle lost must be a counted drop.
    `stages`: wrap the dropping stages (``_DropSources``, a few reductions
    a re-bin); off where the run's ms/step is the number kept.  Returns
    the re-bin launches and the wall time in seconds."""
    import contextlib

    import torch

    from minipic_torch.ops import rebin as rb

    n_live = sum(_live(p) for p in sim.state.species)
    for k in rb.KERNELS.values():
        k.reset()
    drops, prev = [], [sim.state]

    def saver(st, i):
        new = sim.overflow_total - sum(n for _, n, _ in drops)
        if new:
            e = [sum(_energies(s, sim.deck)) for s in (prev[0], st)]
            drops.append((i, new, (e[1] - e[0]) / e[0]))
        prev[0] = st
        if i % every == 0:
            sample(st, i)

    torch.cuda.synchronize()
    with _DropSources() if stages else contextlib.nullcontext() as sources:
        t0 = time.perf_counter()
        sim.run(steps, save_every=1, saver=saver)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rebins = rb.split_kernel.launches
    launches = _auto_route_launches(label, small_only=False)
    live = sum(_live(p) for p in sim.state.species)
    print(f"physics: {label}: {steps} steps in {wall:.2f} s, "
          f"{1e3 * wall / steps:.4f} ms/step, "
          f"{n_live * steps / wall:.4e} pushes/s, "
          f"{rebins // len(sim.deck.species)} re-bins, "
          f"{sim.capacity_changes} capacity changes (buckets now "
          f"{[p.capacity for p in sim.state.species]}), overflow "
          f"{sim.overflow_total}, live {live} (was {n_live}); "
          f"{launches} [{card}]")
    check(all(bool(torch.isfinite(c).all()) for c in sim.state.fields),
          f"{label}: fields not finite")
    check(not closed or live + sim.overflow_total == n_live,
          f"{label}: particles lost without being counted")
    if drops:
        by_stage = sources.read(sim.overflow_total) if stages else "not read"
        print(f"physics: {label}: dropped by stage (particles, tiles) "
              f"{by_stage}; steps that dropped "
              f"(step, particles, total energy change over the step): "
              f"{[(i, n, f'{de:.4e}') for i, n, de in drops]}")
    check(len(drops) <= sim.capacity_changes,
          f"{label}: {len(drops)} steps dropped, "
          f"{sim.capacity_changes} capacity changes")
    return launches, wall


def _energy_acceptance(dev, card: str, precision: str):
    """The 10k-step energy acceptance in `precision` through Simulation.run:
    max |dE|/E0 < 1e-3, overflow 0.  Returns (its re-bin launches, the
    simulation)."""
    from minipic_torch.decks import standard
    from minipic_torch.diag.analysis import energy_drift
    from minipic_torch.simulation import Simulation

    # The energy acceptance deck exactly as scripts/energy_probe.py builds
    # it at docs/energy_tpu_10k_int8q.json's settings: 64^2, ppc 16, u0
    # 0.2, beams at uth 0.05 (ions cold), TSC, int8 (f64: the exact f64
    # deposit, as the JAX package's f64 runs), headroom 3.
    case = standard.two_stream(nx=64, ny=64, ppc=16, u0=0.2)
    sp = tuple(dataclasses.replace(s, uth=(0.05 if s.mass <= 1.0 else 0.0),
                                   shape_order=2)
               for s in case.deck.species)
    deck = dataclasses.replace(case.deck, species=sp, precision=precision,
                               gather_precision="exact",
                               capacity_headroom=3.0)
    sim = Simulation(deck, seed=0, device=dev)
    sim.state = case.seed_state(sim.state, deck)
    hist = []
    label = "two-stream energy acceptance (energy_probe's deck)"
    if precision != "f32":
        label = f"{label} {precision}"
    launches, _ = timed_run(
        sim, ENERGY_STEPS, ENERGY_EVERY,
        lambda st, i: hist.append((i, *_energies(st, deck))), label, card)
    check(len(hist) == ENERGY_STEPS // ENERGY_EVERY + 1, "energy samples")
    check(sim.overflow_total == 0, f"energy deck: overflow "
          f"{sim.overflow_total}")
    tot = [f + k for _, f, k in hist]
    worst = max(range(len(tot)), key=lambda i: abs(tot[i] - tot[0]))
    drift = energy_drift([(f, k) for _, f, k in hist])
    print(f"physics: energy {precision}: E0 {tot[0]:.9e}, max |dE|/E0 "
          f"{drift:.4e} at step {hist[worst][0]}, end "
          f"{abs(tot[-1] - tot[0]) / tot[0]:.4e}, field share at the end "
          f"{hist[-1][1] / tot[-1]:.4e} (bar 1e-3) [{card}]")
    check(drift < 1e-3, f"energy drift {drift:.3e} >= 1e-3")
    return launches, sim


def phase_physics(dev, card: str) -> int:
    """The physics bars on the card, through Simulation.run.  Returns
    append_incoming's launches in the two_stream run."""
    from minipic_torch.decks import standard
    from minipic_torch.diag.analysis import (field_spectrum_x, growth_rate,
                                             two_stream_growth_theory)
    from minipic_torch.simulation import Simulation

    _energy_acceptance(dev, card, "f32")

    case = standard.make("weibel")
    deck = case.deck
    sim = Simulation(deck, seed=0, device=dev)
    sim.state = case.seed_state(sim.state, deck)
    eb = []

    def b_energy(st, i):
        f = st.fields
        eb.append((i, float(0.5 * ((f.bx.double() ** 2).sum()
                                   + (f.by.double() ** 2).sum())
                            * deck.dx * deck.dy)))

    e0 = _energies(sim.state, deck)
    timed_run(sim, deck.total_steps, WEIBEL_EVERY, b_energy, "weibel", card)
    e1 = _energies(sim.state, deck)
    steps = [i for i, _ in eb[1:]]
    times = [i * deck.dt for i in steps]
    energy = [e for _, e in eb[1:]]
    growth = min(energy[-5:]) / energy[0]
    beta0 = 0.6 / math.sqrt(1 + 0.6 * 0.6)
    # The JAX package's window (tests/test_physics_benchmarks.py:113): the
    # first 200 steps sampled every 5, fitted from the fourth sample to the
    # peak; its 0.5-0.85 beta0 was calibrated on its own 32^2 deck.
    n200 = steps.index(200) + 1
    j1 = max(range(n200), key=energy.__getitem__) or n200
    gam_jax = growth_rate(times[3:j1], energy[3:j1])
    # The port's own window over the whole run: from 10x the first sample
    # to a tenth of the peak (the linear phase, before saturation).
    i1 = max(range(len(energy)), key=energy.__getitem__)
    lin = [i for i in range(i1) if 10 * energy[0] < energy[i]
           < 0.1 * energy[i1]]
    check(len(lin) >= 5, f"weibel: {len(lin)} samples in the linear phase")
    gam = growth_rate([times[i] for i in lin], [energy[i] for i in lin])
    print(f"physics: weibel: in-plane B energy {energy[0]:.4e} -> "
          f"{energy[-1]:.4e} (x{growth:.4e}, bar 100), peak at t "
          f"{times[i1]:.2f}; growth rate over the JAX test's window (steps "
          f"{steps[3]}-{steps[j1 - 1]}) {gam_jax / beta0:.4f} beta0 (that "
          f"test's bar 0.5-0.85, on its own deck), over the port's window "
          f"(t {times[lin[0]]:.2f}-{times[lin[-1]]:.2f}, 10x the first "
          f"sample to a tenth of the peak) {gam / beta0:.4f} beta0; total "
          f"energy change {abs(sum(e1) - sum(e0)) / sum(e0):.4e} [{card}]")
    check(growth > 100, f"weibel: B energy grew only x{growth:.3e}")

    case = standard.make("two_stream")
    deck = case.deck
    sim = Simulation(deck, seed=0, device=dev)
    sim.state = case.seed_state(sim.state, deck)
    e0 = _energies(sim.state, deck)
    mode1 = []

    def spectrum(st, i):
        mode1.append((i * deck.dt,
                      float(field_spectrum_x(st.fields.ex.cpu().numpy())[1])))

    launches, _ = timed_run(sim, deck.total_steps, TWO_STREAM_EVERY,
                            spectrum, "two_stream", card)
    e1 = _energies(sim.state, deck)
    # Cold symmetric beams at +-u0, each of density 1/2; the deck's box
    # holds mode 1 near peak growth.
    u0 = deck.species[0].ux
    v0 = u0 / math.sqrt(1 + u0 * u0)
    theory = two_stream_growth_theory(2 * math.pi / deck.box_x, v0,
                                      math.sqrt(0.5))
    p1 = [e for _, e in mode1]
    i1 = max(range(len(p1)), key=p1.__getitem__)
    # The mode-power window of the JAX package's growth-rate test
    # (tests/test_physics_benchmarks.py:64, the same 64-cell FFT), before
    # trapping; this deck's seed is 10x that test's, so the window also
    # starts after the seed's transient (~3/gamma, as that test notes).
    lin = [i for i in range(i1)
           if mode1[i][0] > 3 / theory and 3e-4 < p1[i] < 3e-2]
    fit = "not fitted (under 5 samples in the window)"
    if len(lin) >= 5:
        gam = growth_rate([mode1[i][0] for i in lin], [p1[i] for i in lin])
        fit = (f"{gam:.4f} over t {mode1[lin[0]][0]:.2f}-"
               f"{mode1[lin[-1]][0]:.2f}, {gam / theory:.4f} of theory")
    print(f"physics: two_stream: energy {sum(e0):.9e} -> {sum(e1):.9e} (rel "
          f"change {abs(sum(e1) - sum(e0)) / sum(e0):.4e}); mode-1 power "
          f"peak {p1[i1]:.4e} at t {mode1[i1][0]:.2f}; growth rate past "
          f"t = 3/theory in the JAX test's window (power 3e-4 to 3e-2) "
          f"{fit} (cold-beam theory {theory:.4f}) [{card}]")
    return launches["append_incoming"]


def _open_subset(name: str, dev, seed=31, dtype=None):
    """A cut of deck `name` (OPEN_SUBSETS: its tile shape, guard, order,
    bucket size and f32 deposit) loaded on the card: the electrons up to
    0.3 cells off their tiles inside the box, momenta x20 (uth 0.2), every
    7th slot dead, and in the tiles at each wall particles within 0.2
    cells of it moving out at |u| = 3, through each wall and, diagonally,
    each corner; fields: the deck's laser plus a 0.02 wave on every
    component.  Made in float32; `dtype`: the same values in that type."""
    import torch

    from minipic_torch.decks import standard
    from minipic_torch.fields.halo import pad_fields_periodic
    from minipic_torch.fields.tiles import extract_field_tiles
    from minipic_torch.particles.species import load_species
    from minipic_torch.simulation import bucket_capacity
    from minipic_torch.testing import push_out_through_walls

    case = standard.make(name, **OPEN_SUBSETS[name])
    deck = case.deck
    t = deck.tiling
    cap = bucket_capacity(deck)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = load_species(deck.species[0], deck.domain, t, cap, gen,
                     torch.float32, dev)

    def rnd():
        return torch.rand(p.x.shape, generator=gen, device=dev)

    live = p.w > 0
    nx, ny = float(deck.nx), float(deck.ny)
    x = torch.where(live, (p.x + 0.6 * rnd() - 0.3).clamp(0.01, nx - 0.01),
                    p.x)
    y = torch.where(live, (p.y + 0.6 * rnd() - 0.3).clamp(0.01, ny - 0.01),
                    p.y)
    px, py, pz = p.px * 20.0, p.py * 20.0, p.pz * 20.0
    tid = torch.arange(t.num_tiles, device=dev)[:, None]
    ox, oy = tid % t.tile_cols * t.tile_nx, tid // t.tile_cols * t.tile_ny
    x, y, px, py = push_out_through_walls(x, y, px, py, live, ox, oy,
                                          t.tile_nx, t.tile_ny, nx, ny,
                                          0.2 * rnd())
    slot = torch.arange(cap, device=dev)[None, :]
    w = torch.where(slot % 7 == 5, torch.zeros_like(p.w), p.w)
    p = type(p)(x, y, px, py, pz, w)
    f = case.init_fields(deck, device=dev)
    j = torch.arange(deck.ny, device=dev, dtype=torch.float32)[:, None]
    i = torch.arange(deck.nx, device=dev, dtype=torch.float32)[None, :]
    k = 2 * torch.pi / deck.nx
    f = type(f)(*(a + 0.02 * torch.sin(k * ((c + 1) * i + (2 - c) * j) + c)
                  for c, a in enumerate(f)))
    ft = extract_field_tiles(pad_fields_periodic(f, deck.guard), t.tile_rows,
                             t.tile_cols, t.tile_ny, t.tile_nx, deck.guard)
    if dtype is not None:
        p = type(p)(*(a.to(dtype) for a in p))
        ft = type(ft)(*(a.to(dtype) for a in ft))
    return deck, p, ft


def _open_kw(deck, dev, spec=None, mode="f32"):
    from minipic_torch.simulation import tile_origins

    t = deck.tiling
    spec = deck.species[0] if spec is None else spec
    return dict(qm=spec.charge / spec.mass, q=spec.charge,
                order=spec.shape_order, tile_ny=t.tile_ny, tile_nx=t.tile_nx,
                origins=tile_origins(t, dev), g=deck.guard, dt=deck.dt,
                dx=deck.dx, dy=deck.dy, grid=None, mode=mode)


def _compare_open(deck, p, ft, label: str, kw=None) -> float:
    """The advance kernel against its plain version in the open mode on
    the same inputs: live particles' positions and momenta equal (f64
    mode: within F64_ULPS of each channel's scale), dead slots untouched,
    J within OPEN_J_TOL of its peak (f64 mode: F64_J_TOL); returns the
    largest absolute difference of J."""
    import torch

    from minipic_torch.ops.advance import (advance_kernel, advance_plain,
                                           live_watermark)

    kw = _open_kw(deck, p.x.device) if kw is None else kw
    f64 = kw["mode"] == "f64"
    counts = live_watermark(p.w)
    pk, jk, dk = advance_kernel(p, ft, counts, **kw)
    pp, jp, dp = advance_plain(p, ft, counts, **kw)
    torch.cuda.synchronize()
    live = p.w > 0
    for name, a, b, old in zip(("x", "y", "px", "py", "pz"), pk, pp, p):
        d = (a - b)[live].abs()
        if f64:
            u = _ulps(a[live], b[live])
            check(u <= F64_ULPS, f"{label} {name}: {u:.2f} ulps of the "
                  f"channel's scale (max diff {float(d.max()):.3e})")
        else:
            check(torch.equal(a[live], b[live]),
                  f"{label} {name}: {int((d > 0).sum())} of "
                  f"{int(live.sum())} live particles differ, by up to "
                  f"{float(d.max()):.3e}")
        check(torch.equal(a[~live], old[~live]),
              f"{label} {name}: dead slots changed")
    err = 0.0
    tol = F64_J_TOL if f64 else OPEN_J_TOL
    for name, a, b in zip(("jx", "jy", "jz"), jk, jp):
        scale = float(b.abs().max())
        d = float((a - b).abs().max())
        check(d <= tol * scale, f"{label} {name}: {d} > {tol} * {scale}")
        err = max(err, d)
    dtol = 1e-12 if f64 else 1e-6
    check(abs(float(dk.max()) - float(dp.max())) <= dtol * float(dp.max()),
          f"{label}: dmax differs")
    return err


def phase_diag(dev, card: str) -> dict:
    """The diagnostics kernels against their plain versions at the
    headline's shape (phase 2); returns each one's numbers for the JSON
    line, with the f64 channels' under "f64"."""
    import torch

    from minipic_torch.core.state import (FieldState, kinetic_energy_plain,
                                          momentum_sum_plain)
    from minipic_torch.ops import diag as dg
    from minipic_torch.testing import diag_species

    def rel(a, b, scale) -> float:
        return float(((a - b).abs() / scale.clamp(min=1e-300)).max())

    out = {}
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        p = diag_species(DIAG_TILES, DIAG_CAP, live=DIAG_LIVE / DIAG_CAP,
                         dtype=dtype, seed=17, device=dev)
        gen = torch.Generator(device=dev).manual_seed(18)
        f = FieldState(*(torch.randn((512, 512), generator=gen, device=dev,
                                     dtype=dtype) * 0.01 for _ in range(6)))
        e = p.w.element_size()
        n = p.w.numel()
        n_live = _live(p)
        lanes = 16 // e
        live_vec = int((p.w.reshape(-1, lanes) != 0).any(1).sum()) * lanes
        ke, mom = dg.moments_kernel(p, 1.0)
        ke2, mom2 = dg.moments_kernel(p, 1.0)
        want_ke, want_mom = kinetic_energy_plain(p, 1.0), momentum_sum_plain(
            p, 1.0)
        w = p.w.double()
        scale = torch.stack([(w * a.double()).abs().sum()
                             for a in (p.px, p.py, p.pz)])
        check(torch.equal(ke, ke2) and torch.equal(mom, mom2),
              f"diag {tag}: two moments launches differ")
        err_m = max(rel(ke, want_ke, want_ke.abs()), rel(mom, want_mom, scale))
        check(err_m <= DIAG_RTOL, f"diag {tag}: moments off by {err_m:.3e}")
        c = dg.census_kernel([p], (True,), f, 0.1, 0.1)
        c2 = dg.census_kernel([p], (True,), f, 0.1, 0.1)
        cp = dg.census_plain([p], (True,), f, 0.1, 0.1)
        check(all(torch.equal(a, b) for a, b in zip(c, c2)),
              f"diag {tag}: two census launches differ")
        check(int(c.live) == int(cp.live) == n_live
              and int(c.nonuniform) == int(cp.nonuniform) == 0,
              f"diag {tag}: census live {int(c.live)} / {int(cp.live)} "
              f"of {n_live}, flags {int(c.nonuniform)}")
        err_c = rel(c.field_energy, cp.field_energy, cp.field_energy)
        check(err_c <= DIAG_RTOL, f"diag {tag}: field energy off by "
              f"{err_c:.3e}")
        # Bytes the kernels read (w, and the momenta of vectors with a live
        # slot; the census w and the fields), and the least the work needs
        # (the momenta of live slots only).
        read = {"moments": e * (n + 3 * live_vec),
                "census": e * (n + 6 * 512 * 512)}
        need = {"moments": e * (n + 3 * n_live), "census": read["census"]}
        runs = {
            "moments": (lambda: dg.moments_kernel(p, 1.0),
                        lambda: (kinetic_energy_plain(p, 1.0),
                                 momentum_sum_plain(p, 1.0)), err_m),
            "census": (lambda: dg.census_kernel([p], (True,), f, 0.1, 0.1),
                       lambda: dg.census_plain([p], (True,), f, 0.1, 0.1),
                       err_c)}
        for name, (kern, plain, err) in runs.items():
            v = dict(max_rel_err=err, ms=cuda_ms(kern, 20, warm=2),
                     plain_ms=cuda_ms(plain, 3), bytes_read=read[name],
                     **bound(need[name]))
            v["hbm_share"] = read[name] / (v["ms"] / 1e3) / HBM_BYTES_PER_S
            out.setdefault(name, {})
            if tag == "f32":
                out[name].update(v)
            else:
                out[name]["f64"] = v
            print(f"diag {tag}: {name} at the headline's shape "
                  f"({DIAG_TILES} x {DIAG_CAP} slots, {n_live} live): kernel "
                  f"{v['ms']:.4f} ms, plain {v['plain_ms']:.3f} ms, bound "
                  f"{v['bound_ms']:.4f} ms ({v['bound_by']}); "
                  f"{read[name] / 1e9:.3f} GB read at "
                  f"{read[name] / (v['ms'] / 1e3) / 1e12:.3f} TB/s, "
                  f"{100 * v['hbm_share']:.1f}% of the HBM rate; max rel err "
                  f"{err:.2e}, two launches bit-equal [{card}]")
        del p, f, w, want_ke, want_mom
        torch.cuda.empty_cache()
    return out


def phase_open_kernel(dev) -> None:
    """The advance in its open mode (grid None) against its plain version
    at the laser decks' shapes, leavers through every wall and corner and
    dead slots included; the periodic mode on the same subsets still
    matches."""
    import torch

    from minipic_torch.ops.advance import advance_kernel, live_watermark

    # Both decks in f32; laser_plasma's also in f64 (B1's f64 mode between
    # absorbing walls).
    for name, mode in [(n, "f32") for n in OPEN_SUBSETS] + [
            ("laser_plasma", "f64")]:
        deck, p, ft = _open_subset(
            name, dev, dtype=torch.float64 if mode == "f64" else None)
        t = deck.tiling
        label = (f"open {name} shape (order {deck.species[0].shape_order}, "
                 f"{t.tile_ny + 2 * deck.guard}^2 windows, "
                 f"{p.capacity} slots, {mode})")
        kw = _open_kw(deck, dev, mode=mode)
        err = _compare_open(deck, p, ft, label, kw)
        # The leavers' moves, stored unwrapped: out through every wall.
        (x1, y1, *_), _, _ = advance_kernel(p, ft, live_watermark(p.w), **kw)
        live = p.w > 0
        x1, y1 = x1[live], y1[live]
        out = [int(o.sum()) for o in (x1 < 0, x1 >= deck.nx, y1 < 0,
                                      y1 >= deck.ny)]
        corners = int((((x1 < 0) | (x1 >= deck.nx))
                       & ((y1 < 0) | (y1 >= deck.ny))).sum())
        check(min(out) >= 4 and corners >= 4,
              f"{label}: leavers {out}, through corners {corners}")
        perr = _compare(p, ft, live_watermark(p.w),
                        dict(kw, grid=(deck.nx, deck.ny)),
                        f"{label}, periodic mode")
        print(f"kernel: {label}: {int(live.sum())} particles, leavers "
              f"(x<0, x>=nx, y<0, y>=ny) {out}, through corners {corners}: "
              f"positions and momenta equal"
              f"{f' within {F64_ULPS} ulps' if mode == 'f64' else ''}, J "
              f"max abs err {err:.3e}; the periodic mode on the same subset "
              f"max abs err {perr:.3e}")


def phase_open_twins(dev) -> None:
    """The open-boundary decks at small sizes (OPEN_TWINS) stepped on the
    card and on the CPU from one state, as phase_decks does: the pulse
    alone, laser_plasma between absorbing walls, laser_wakefield_window
    through two window shifts (its injection is drawn on the host, the
    same plasma on both devices)."""
    from minipic_torch import bridge
    from minipic_torch.decks import standard
    from minipic_torch.ops import rebin as rb
    from minipic_torch.ops.advance import advance_kernel

    for name, (kw, steps) in OPEN_TWINS.items():
        case = standard.make(name, **kw)
        deck = case.deck
        cpu = case.simulation(seed=1, device="cpu")
        gpu = case.simulation(seed=1, device=dev)
        gpu.state = bridge.sim_state_from_numpy(
            bridge.sim_state_to_numpy(cpu.state), dev)
        n_live = sum(_live(p) for p in gpu.state.species)
        advance_kernel.launches = 0
        for k in rb.KERNELS.values():
            k.reset()
        rebins = 0
        for i in range(steps):
            dc, dg = cpu.step(), gpu.step()
            fe = (float(dg.field_energy), float(dc.field_energy))
            check(abs(fe[0] - fe[1]) <= 1e-4 * abs(fe[1]) + 1e-12,
                  f"{name} step {i}: field energy {fe}")
            kg, kc = dg.kinetic_energy.cpu(), dc.kinetic_energy
            tol = 1e-5 * kc.abs() + 1e-7 * float(kc.sum())
            check(bool(((kg - kc).abs() <= tol).all()),
                  f"{name} step {i}: kinetic energy {kg} vs {kc}")
            check(int(dg.shard_live[0]) == int(dc.shard_live[0]),
                  f"{name} step {i}: live {int(dg.shard_live[0])} vs "
                  f"{int(dc.shard_live[0])}")
            check(dg.rebinned == dc.rebinned and int(dg.overflow) == 0
                  and int(dc.overflow) == 0,
                  f"{name} step {i}: re-bin or overflow differs")
            rebins += dg.rebinned
        w0 = None
        if deck.moving_window:
            w0 = (int(gpu.state.window_x0), int(cpu.state.window_x0))
            check(w0[0] == w0[1] == 2 * deck.tile_nx,
                  f"{name}: window_x0 {w0}")
        n_species = len(deck.species)
        check(advance_kernel.launches == steps * n_species,
              f"{name}: {advance_kernel.launches} advance launches")
        check(rb.split_kernel.launches == rebins * n_species,
              f"{name}: {rb.split_kernel.launches} split launches for "
              f"{rebins} re-bins")
        check(not n_species or rebins >= 1, f"{name}: no re-bin")
        live = sum(_live(p) for p in gpu.state.species)
        print(f"open twins: {name} {deck.nx}x{deck.ny}, {n_live} particles, "
              f"buckets {[p.capacity for p in gpu.state.species]}: {steps} "
              f"steps on the card match the CPU (field energy {fe[0]:.6e} vs "
              f"{fe[1]:.6e}, live {live}, {rebins} re-bins, window_x0 {w0}; "
              f"launches: advance {advance_kernel.launches}, split "
              f"{rb.split_kernel.launches}, append_incoming "
              f"{rb.append_incoming_kernel.launches}, defrag "
              f"{rb.defrag_kernel.launches})")


def _pulse_physics(dev, card: str, precision: str = "f32") -> None:
    """reference_pulse in `precision` for its full span through
    Simulation.run, the mid-y Bz lineout collected on the device every
    total_steps // 260 steps (the JAX package's validation run's
    sampling): the pulse's speed and its two peak amplitudes at t = 500
    against docs/VALIDATION.md."""
    import numpy as np
    import torch

    from minipic_torch.decks import standard
    from minipic_torch.diag.analysis import (fdtd_dispersion_velocity,
                                             fit_pulse_speed, lineout,
                                             peak_amplitudes,
                                             track_peak_speed)

    case = standard.make("reference_pulse")
    deck = dataclasses.replace(case.deck, precision=precision)
    case = dataclasses.replace(case, deck=deck)
    sim = case.simulation(device=dev)
    check(sim.state.fields.bz.dtype == deck.dtype, "reference_pulse dtype")
    n = deck.total_steps
    every = n // PULSE_SAMPLES
    mid = deck.ny // 2
    lines = []

    def sample(st, i):
        if i:
            lines.append(st.fields.bz[mid].clone())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(n, save_every=every, saver=sample)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = torch.stack(lines).cpu().double().numpy()
    times = np.arange(1, len(lines) + 1) * every * deck.dt
    speed = fit_pulse_speed(times, lines, deck.dx)
    n_fit = max(8, int(3.0 * deck.box_x / deck.dt / every))
    tracked = track_peak_speed(times[:n_fit], lines[:n_fit], deck.dx)
    theory = fdtd_dispersion_velocity(5 * 2 * math.pi / deck.box_x, deck.dt,
                                      deck.dx)
    bz = sim.state.fields.bz.double().cpu().numpy()
    check(bool(np.isfinite(bz).all()), "reference_pulse: fields not finite")
    p1, p2 = peak_amplitudes(lineout(bz))
    p10, p20 = peak_amplitudes(lineout(
        case.init_fields(deck, device="cpu").bz.double().numpy()))
    print(f"physics: reference_pulse {deck.nx}^2 {precision}: {n} steps (t "
          f"{n * deck.dt:.4f}) in {wall:.2f} s, {1e3 * wall / n:.4f} ms/step; "
          f"{len(lines)} lineouts every {every} steps; leading-peak speed "
          f"(fit_pulse_speed) {speed:.6f} c (bar: within 2e-4 of the "
          f"report's 0.99977, at most 1.0001), crest tracked over the first "
          f"3 transits {tracked:.6f} c, FDTD theory {theory:.6f} c; Bz peak "
          f"amplitudes {p10:.5f} / {p20:.5f} -> {p1:.5f} / {p2:.5f} (bars "
          f"0.0833 / 0.0683 within 3%) [{card}]")
    check(abs(speed - 0.99977) <= 2e-4 and speed <= 1.0001,
          f"reference_pulse: speed {speed}")
    check(abs(p1 / 0.0833 - 1) <= 0.03 and abs(p2 / 0.0683 - 1) <= 0.03,
          f"reference_pulse: peak amplitudes {p1}, {p2}")


# The JAX package's f64 record of the energy deck, on the CPU (its f64 TPU
# backend crashed: scripts/energy_probe.py:35-36); printed for reference.
JAX_F64_RECORD = "docs/energy_cpu64_3k.json"


def phase_f64_physics(dev, card: str) -> dict:
    """The f64 runs at full size on the card: the 10k-step energy
    acceptance in f64 (printed beside the JAX package's CPU f64 record),
    then append_incoming's numbers on its final state (B6 in f64), and
    reference_pulse in f64 for its 63,639 steps.  Returns B6's numbers with
    its launches in the energy run."""
    launches, sim = _energy_acceptance(dev, card, "f64")
    with open(ROOT / JAX_F64_RECORD) as f:
        rec = json.load(f)
    cfg = rec["config"]
    print(f"physics: for reference only, the JAX package's f64 record "
          f"({JAX_F64_RECORD}: {cfg['platform']}, order {cfg['order']}, "
          f"{cfg['steps']} steps in {rec['wall_s']} s): max |dE|/E0 "
          f"{rec['max_drift']:.4e}, overflow {rec['overflow']}")
    deck = sim.deck
    b6 = _route_numbers(sim.state.species[0], deck)["append_incoming"]
    b6["launches"] = launches["append_incoming"]
    del sim
    _pulse_physics(dev, card, "f64")
    return b6


def _route_numbers(p, deck, reps=20) -> dict:
    """The re-bin kernels of the route that rebin_auto takes on `p`: the
    split, then the segment, the append and the defrag (the deal route,
    buckets of 8 runs + 256 slots or more) or append_incoming and the
    dense defrag (the small-bucket route); each against its plain version
    on the split's output, with its plain time (CUDA events), its bound,
    and a job for device_times."""
    from minipic_torch.ops import rebin as rb
    from minipic_torch.particles.binning import route_movers
    from minipic_torch.simulation import rebin_caps

    t = deck.tiling
    T, cap = p.x.shape
    # Bytes of one channel value and of one slot's six.
    e = p.x.element_size()
    sb = 6 * e
    mc, sc = rebin_caps(deck, cap)
    deal = sc > 0 and cap >= 8 * sc + 256
    skw = dict(tile_cols=t.tile_cols, tile_ny=t.tile_ny, tile_nx=t.tile_nx,
               b_cap=mc)
    got = rb.split_kernel(p, **skw)
    want = rb.split_buckets_plain(p, **skw)
    out = dict(split=dict(
        max_abs_err=max(_same(a, b, f"route split {i}")
                        for i, (a, b) in enumerate(zip(got, want))),
        plain_ms=cuda_ms(lambda: rb.split_buckets_plain(p, **skw), 1),
        job=(lambda: rb.split_kernel(p, **skw), reps, "split_kernel"),
        **bound(2 * sb * T * cap + sb * T * mc + 8 * T)))
    p1, movers, wm, _ = got
    # Each defrag merges into a fresh copy of the split buckets.
    copies = iter([_clone(p1) for _ in range(reps + 1)])
    if deal:
        gkw = dict(tile_rows=t.tile_rows, tile_cols=t.tile_cols,
                   tile_ny=t.tile_ny, tile_nx=t.tile_nx, b_seg=sc)
        seg, sd = rb.segment_kernel(movers, **gkw)
        seg_p, sd_p = rb.segment_movers_plain(movers, **gkw)
        out["segment"] = dict(
            max_abs_err=max(_same(seg, seg_p, "route segment"),
                            _same(sd, sd_p, "route segment dropped")),
            plain_ms=cuda_ms(lambda: rb.segment_movers_plain(movers, **gkw),
                             1),
            job=(lambda: rb.segment_kernel(movers, **gkw), reps,
                 "segment_kernel"),
            **bound(sb * T * mc + sb * T * 8 * sc + 4 * T))
        nbr = rb.seg_neighbor_table(t.tile_rows, t.tile_cols, p.x.device)
        n_in = int((seg.w > 0).sum())
        want, want_d = rb.append_segments_plain(p1, seg, wm, nbr, b_seg=sc)
        q = _clone(p1)
        got_d = rb.append_kernel(q, seg, wm, nbr, b_seg=sc)
        # The append is idempotent on its own output (same runs, same
        # watermarks), so repeated launches time it fairly.
        out["append"] = dict(
            max_abs_err=max(_same(q, want, "route append"),
                            _same(got_d, want_d, "route append dropped")),
            plain_ms=cuda_ms(lambda: rb.append_segments_plain(
                p1, seg, wm, nbr, b_seg=sc), 1),
            job=(lambda: rb.append_kernel(q, seg, wm, nbr, b_seg=sc), reps,
                 "append_kernel"),
            **bound(e * T * 8 * sc + 2 * sb * n_in + 40 * T))
        inc = rb.roll_segments(seg, nbr, sc)
        want, want_c, want_d = rb.defrag_buckets_plain(p1, inc)
        r = _clone(p1)
        got_c, got_d = rb.defrag_kernel(r, seg, nbr, b_seg=sc)
        defrag_job = (lambda: rb.defrag_kernel(next(copies), seg, nbr,
                                               b_seg=sc), reps,
                      "defrag_kernel")
        in_bytes = e * T * 8 * sc + sb * n_in + 32 * T
    else:
        inc, _ = route_movers(movers, t, mc)
        n_in = int((inc.w > 0).sum())
        want, want_d = rb.append_incoming_plain(p1, inc, wm)
        q = _clone(p1)
        got_d = rb.append_incoming_kernel(q, inc, wm)
        out["append_incoming"] = dict(
            max_abs_err=max(_same(q, want, "route append_incoming"),
                            _same(got_d, want_d,
                                  "route append_incoming dropped")),
            plain_ms=cuda_ms(lambda: rb.append_incoming_plain(p1, inc, wm),
                             1),
            wrapper_ms=cuda_ms(lambda: rb.append_incoming_kernel(q, inc, wm),
                               reps),
            job=(lambda: rb.append_incoming_kernel(q, inc, wm), reps,
                 "append_rows_kernel"),
            **bound(e * T * mc + 4 * T + 2 * sb * n_in))
        want, want_c, want_d = rb.defrag_buckets_plain(p1, inc)
        r = _clone(p1)
        got_c, got_d = rb.defrag_kernel(r, inc)
        defrag_job = (lambda: rb.defrag_kernel(next(copies), inc), reps,
                      "defrag_kernel")
        in_bytes = sb * T * mc
    out["defrag"] = dict(
        max_abs_err=max(_same(r, want, "route defrag"),
                        _same(got_c, want_c, "route defrag counts"),
                        _same(got_d, want_d, "route defrag dropped")),
        plain_ms=cuda_ms(lambda: rb.defrag_buckets_plain(p1, inc), 1),
        job=defrag_job, **bound(2 * sb * T * cap + in_bytes + 8 * T))
    for v in out.values():
        v.update(route="deal" if deal else "small-bucket",
                 shape=f"{T} tiles x {cap} slots, mover buffer {mc}"
                 + (f", runs {sc}" if deal else ""))
    return out


def _laser_plasma_physics(dev, card: str) -> dict:
    """laser_plasma at its default size for its full sim_time through
    Simulation.run: total energy finite and never above 1.01x its start,
    every drop counted and followed by growth; then the advance in its
    open mode on the final state (time, bound, launches a step) and, for
    each species, the re-bin kernels of the route its buckets take
    there (_route_numbers)."""
    from minipic_torch.decks import standard
    from minipic_torch.fields.halo import pad_fields_periodic
    from minipic_torch.fields.tiles import extract_field_tiles
    from minipic_torch.ops.advance import (advance_kernel, advance_plain,
                                           live_watermark)

    case = standard.make("laser_plasma")
    deck = case.deck
    sim = case.simulation(device=dev)
    hist = []
    advance_kernel.launches = 0
    launches, wall = timed_run(
        sim, deck.total_steps, OPEN_ENERGY_EVERY,
        lambda st, i: hist.append((i, sum(_energies(st, deck)))),
        "laser_plasma", card, closed=False, stages=False)
    steps = deck.total_steps
    per_step = advance_kernel.launches / steps
    e0 = hist[0][1]
    worst = max(hist, key=lambda h: h[1])
    print(f"physics: laser_plasma: total energy {e0:.6e} -> {hist[-1][1]:.6e}"
          f" (highest {worst[1] / e0:.6f} x E0 at step {worst[0]}, bar "
          f"1.01), overflow {sim.overflow_total}, advance launches "
          f"{per_step:g} a step [{card}]")
    check(all(math.isfinite(e) for _, e in hist), "laser_plasma: energy")
    check(worst[1] <= 1.01 * e0, f"laser_plasma: energy {worst[1] / e0}")
    check(per_step == len(deck.species), "laser_plasma: advance launches")

    p = sim.state.species[0]
    t = deck.tiling
    T = p.num_tiles
    ft = extract_field_tiles(pad_fields_periodic(sim.state.fields,
                                                 deck.guard), t.tile_rows,
                             t.tile_cols, t.tile_ny, t.tile_nx, deck.guard)
    kw = _open_kw(deck, dev)
    counts = live_watermark(p.w)
    err = _compare_open(deck, p, ft, "open laser_plasma final state", kw)
    n_wm = int(counts.sum())
    win = T * (t.tile_ny + 2 * deck.guard) * (t.tile_nx + 2 * deck.guard)
    adv = dict(deck="laser_plasma", state="final", launches_per_step=per_step,
               max_abs_err=err,
               ms=cuda_ms(lambda: advance_kernel(p, ft, counts, **kw), 10),
               plain_ms=cuda_ms(lambda: advance_plain(p, ft, counts, **kw),
                                2),
               **bound(4 * (11 * n_wm + 9 * win + T),
                       ADVANCE_OPS_PER_PARTICLE * _live(p)))
    adv.pop("library_ms")
    print(f"physics: laser_plasma: advance (open mode, f32, CIC, 20^2 "
          f"windows) on the final state's electrons ({_live(p)} live, "
          f"{p.capacity}-slot buckets): kernel {adv['ms']:.4f} ms, plain "
          f"{adv['plain_ms']:.3f} ms, bound {adv['bound_ms']:.4f} ms "
          f"({adv['bound_by']}), {wall * 1e3 / steps:.4f} ms/step "
          f"[{card}]")
    rebin = {spec.name: _route_numbers(q, deck)
             for spec, q in zip(deck.species, sim.state.species)}
    return adv, rebin, launches, wall * 1e3 / steps


def _window_census(dev, steps: int, nx: int):
    """laser_wakefield_window for `steps` steps with its walls, shifts and
    injections counted on the device: per species, the live particles
    killed at each wall (x < 0, x >= nx, y < 0, y >= ny) over the run and
    after the first full transit, the live count's change across the
    shifts (the injected column less the dropped one), and the largest
    relative error of an injected live weight against the profile at
    absolute x.  Kept out of the timed run: it adds reductions to every
    step."""
    import torch

    from minipic_torch import simulation
    from minipic_torch.decks import standard
    from minipic_torch.particles import species as species_mod

    case = standard.make("laser_wakefield_window")
    deck = case.deck
    sim = case.simulation(device=dev)
    n_sp = len(deck.species)
    real_inject = species_mod.inject_column
    real_wrap = simulation.wrap_positions
    real_shift = simulation.shift_window
    # Per species: killed through x < 0, x >= nx, y < 0, y >= ny (a corner
    # counts at both its walls), and killed in all.
    walls = torch.zeros((n_sp, 5), dtype=torch.int64, device=dev)
    shifted = torch.zeros(n_sp, dtype=torch.int64, device=dev)
    worst = [torch.zeros((), dtype=torch.float64, device=dev), 0]
    calls = [0]

    def live(st):
        return torch.stack([(p.w > 0).sum() for p in st.species])

    def wrap(p, nx, ny, periodic):
        alive = p.w > 0
        off_x, off_y = (p.x < 0) | (p.x >= nx), (p.y < 0) | (p.y >= ny)
        walls[calls[0] % n_sp] += torch.stack([(alive & c).sum() for c in (
            p.x < 0, p.x >= nx, p.y < 0, p.y >= ny, off_x | off_y)])
        calls[0] += 1
        return real_wrap(p, nx, ny, periodic)

    def shift(deck_, state, w0n):
        before = live(state)
        out = real_shift(deck_, state, w0n)
        shifted.add_(live(out) - before)
        return out

    def inject(spec, domain, tiling, capacity, key, x0, dtype, device,
               row_ids=None):
        inj = real_inject(spec, domain, tiling, capacity, key, x0, dtype,
                          device, row_ids)
        ref = (spec.density((inj.x.double() + x0) * domain.dx,
                            inj.y.double() * domain.dy)
               * (domain.dx * domain.dy / spec.ppc))
        rel = (inj.w.double() - ref).abs() / ref
        worst[0] = torch.maximum(worst[0], torch.where(
            inj.w > 0, rel, torch.zeros_like(rel)).max())
        worst[1] += 1
        return inj

    at_transit = []

    def saver(st, i):
        if not at_transit and int(st.window_x0) >= nx:
            at_transit.append(walls.clone())

    n0 = live(sim.state)
    species_mod.inject_column = inject
    simulation.wrap_positions = wrap
    simulation.shift_window = shift
    try:
        sim.run(steps, save_every=OPEN_WINDOW_EVERY, saver=saver)
    finally:
        species_mod.inject_column = real_inject
        simulation.wrap_positions = real_wrap
        simulation.shift_window = real_shift
    check(bool(at_transit), "laser_wakefield_window census: no transit")
    return dict(walls=walls.tolist(),
                walls_after_transit=(walls - at_transit[0]).tolist(),
                shifted=shifted.tolist(), change=(live(sim.state) - n0)
                .tolist(), overflow=sim.overflow_total,
                shifts=int(sim.state.window_x0) // deck.tile_nx,
                injected=worst[1], weight_err=float(worst[0]))


def _window_physics(dev, card: str) -> None:
    """laser_wakefield_window at its default size through Simulation.run for
    OPEN_WINDOW_STEPS (its full sim_time unless cut), timed with nothing
    but the live count read every OPEN_WINDOW_EVERY steps: the window's
    shifts against the schedule, and each species' live count after the
    first full transit against a tenth of that species' tile column
    (tests/test_moving_window.py:86-87).  A species that the census
    (_window_census, a second run) sees leave through the walls after the
    transit is held instead to the census's books: its live count moves
    by exactly the shifts' net injection less its kills at the walls
    (tests/test_torch_decks.py's twin pins those kills to JAX's, ROADMAP
    C).  Every injected live weight is the profile's at absolute x."""
    from minipic_torch.decks import standard
    from minipic_torch.simulation import window_shift_now

    case = standard.make("laser_wakefield_window")
    deck = case.deck
    steps = OPEN_WINDOW_STEPS or deck.total_steps
    sim = case.simulation(device=dev)
    samples = []

    def sample(st, i):
        samples.append((i, int(st.window_x0),
                        [_live(p) for p in st.species]))

    _, wall = timed_run(sim, steps, OPEN_WINDOW_EVERY, sample,
                        "laser_wakefield_window", card, closed=False,
                        stages=False)
    w0 = int(sim.state.window_x0)
    del sim
    sched = 0
    for s in range(steps):
        if window_shift_now(s, sched, deck.dt, deck.tile_nx, deck.dx):
            sched += deck.tile_nx
    formula = int(steps * deck.dt / deck.dx / deck.tile_nx)
    transit = next((k for k, (_, x0, _) in enumerate(samples)
                    if x0 >= deck.nx), None)
    check(transit is not None, "laser_wakefield_window: no full transit")
    base = samples[transit][2]
    spread = [max(abs(s[2][k] - base[k]) for s in samples[transit:])
              for k in range(len(base))]
    ends = [n - b for n, b in zip(samples[-1][2], base)]
    # One tile column of each species: its ppc in ny x tile_nx cells.
    cols = [deck.ny * deck.tile_nx * sp.ppc for sp in deck.species]
    print(f"physics: laser_wakefield_window {deck.nx}x{deck.ny}: {steps} "
          f"steps (t {steps * deck.dt:.3f}) in {wall:.2f} s, "
          f"{1e3 * wall / steps:.4f} ms/step; {w0 // deck.tile_nx} shifts "
          f"(schedule {sched // deck.tile_nx}, floor(steps dt/dx/tile_nx) "
          f"{formula}); live per species after the first full transit "
          f"(step {samples[transit][0]}) {base}, largest change since "
          f"{spread}, at the end {ends} (bar: 0.1 x one tile "
          f"column of the species = {[0.1 * c for c in cols]}) [{card}]")
    check(w0 == sched and abs(w0 // deck.tile_nx - formula) <= 1,
          f"laser_wakefield_window: window_x0 {w0}")

    c = _window_census(dev, steps, deck.nx)
    print(f"physics: laser_wakefield_window census run ({steps} steps, "
          f"{c['shifts']} shifts): killed at the walls (x<0, x>=nx, y<0, "
          f"y>=ny, all) per species {c['walls']}, of them after the first "
          f"full transit {c['walls_after_transit']}; live change over the "
          f"run {c['change']} = net injection at the shifts "
          f"{c['shifted']} less the kills at the walls, overflow "
          f"{c['overflow']}; "
          f"{c['injected']} injected columns, largest relative weight error "
          f"{c['weight_err']:.3e} (bar 1e-6) [{card}]")
    check(c["shifts"] == w0 // deck.tile_nx,
          "laser_wakefield_window census: shifts differ")
    check(c["injected"] == len(deck.species) * c["shifts"]
          and c["weight_err"] <= 1e-6,
          "laser_wakefield_window: injected weights")
    # The books: each change of the live count is a shift's net injection,
    # a kill at a wall, or a counted drop (per species when none dropped).
    killed = [k[4] for k in c["walls"]]
    check(sum(c["change"]) == sum(c["shifted"]) - sum(killed)
          - c["overflow"] and (c["overflow"] > 0 or all(
              ch == sh - k for ch, sh, k in zip(
                  c["change"], c["shifted"], killed))),
          "laser_wakefield_window: live count off the census's books")
    held = []
    for k, sp in enumerate(deck.species):
        if c["walls_after_transit"][k][4] == 0:
            check(spread[k] <= 0.1 * cols[k],
                  f"laser_wakefield_window: {sp.name} live {spread[k]}")
            held.append(f"{sp.name} to the bar")
        else:
            held.append(f"{sp.name} to the books (leaves through the walls)")
    print(f"physics: laser_wakefield_window: live counts held: "
          f"{', '.join(held)} [{card}]")


def phase_open_physics(dev, card: str) -> dict:
    """The open-boundary decks at their default sizes on the card:
    reference_pulse, laser_plasma and laser_wakefield_window (bars in each
    function).  Returns laser_plasma's numbers: the open advance's, per
    species those of its re-bin route's kernels, the re-bin launches of
    its run and its ms/step through Simulation.run."""
    import torch

    _pulse_physics(dev, card)
    torch.cuda.empty_cache()
    numbers = _laser_plasma_physics(dev, card)
    torch.cuda.empty_cache()
    _window_physics(dev, card)
    return numbers


def _run(sim, steps: int, card: str, label: str, force_at=None):
    """Step `sim` `steps` times, timing each step; returns (per-step ms of
    advance-only and of re-bin steps, overflow, live before/after, relative
    energy change, peak memory GB)."""
    import torch

    from minipic_torch.core.state import (field_energy_plain,
                                          kinetic_energy_plain)

    deck = sim.deck
    p0 = sim.state.species[0]
    n_live = int((p0.w > 0).sum())
    # The plain versions: the steps' own diagnostics kernels count their
    # launches from here.
    e0 = (float(field_energy_plain(sim.state.fields, deck.dx, deck.dy))
          + float(kinetic_energy_plain(p0, deck.species[0].mass)))
    overflow = torch.zeros((), dtype=torch.int32, device=p0.x.device)
    del p0  # would hold the first state's buckets through the run
    torch.cuda.reset_peak_memory_stats()
    adv_ms, rebin_ms = [], []
    for i in range(steps):
        if i == force_at:
            sim.force_rebin()
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


def phase_main(dev, card: str, precision: str = "f32") -> dict:
    """The headline deck as bench.py builds it, on the card (`precision`
    "f64": the same deck in f64, the advance's f64 mode and the re-bin
    kernels over float64 channels); returns each kernel's numbers for the
    JSON line: launches in the run, and error and times at its shape."""
    import torch

    from minipic_torch import headline
    from minipic_torch.ops import diag as dg
    from minipic_torch.ops import rebin as rb
    from minipic_torch.ops.advance import advance_kernel
    from minipic_torch.simulation import Simulation, deposit_modes

    deck = dataclasses.replace(headline.headline_deck(), precision=precision)
    check(deck.rebin_mode == "auto", "headline deck is not bench.py's")
    mode = deposit_modes(deck)[0]
    f64 = mode == "f64"
    check(mode == ("f64" if precision == "f64" else "int8"),
          f"headline {precision} deposit mode {mode}")
    tag = "main" if precision == "f32" else f"main {precision}"
    t0 = time.perf_counter()
    sim = Simulation(deck, seed=0, device=dev)
    torch.cuda.synchronize()
    p0 = sim.state.species[0]
    print(f"{tag}: {int((p0.w > 0).sum())} particles, buckets "
          f"{tuple(p0.x.shape)} {p0.x.dtype}, {deck.nx}^2, TSC, {mode} "
          f"deposit, deal-route re-bin; loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    del p0
    advance_kernel.launches = 0
    for k in (*rb.KERNELS.values(), *dg.KERNELS.values()):
        k.reset()
    rebin_ms = _run(sim, MAIN_STEPS, card, tag)
    launches = {"advance": advance_kernel.launches,
                **{n: k.launches for n, k in rb.KERNELS.items()}}
    diag_launches = {n: k.launches for n, k in dg.KERNELS.items()}
    print(f"{tag}: diagnostics launches {diag_launches}")
    check(all(v == MAIN_STEPS for v in diag_launches.values()),
          f"{tag}: diagnostics launches {diag_launches} in {MAIN_STEPS} "
          "steps (one moments and one census a step)")
    ran = (rb.append_kernel.taken_count(), rb.defrag_kernel.taken_count())
    print(f"{tag}: launches {launches}; append/defrag ran "
          f"{ran[0]}/{ran[1]}")
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
    from minipic_torch.particles.binning import (rebin, rebin_auto,
                                                 rebin_incremental)

    fields = sim.state.fields
    p = sim.state.species[0]
    t = deck.tiling
    T, cap = p.x.shape
    numbers = {}
    ft = extract_field_tiles(pad_fields_periodic(fields, deck.guard),
                             t.tile_rows, t.tile_cols, t.tile_ny, t.tile_nx,
                             deck.guard)
    counts = live_watermark(p.w)
    kw = _kw(deck, mode, dev)
    err = _compare(p, ft, counts, kw, f"{tag}-path shape o2 {mode}")
    fused_ms = _compare_fused(p, ft, counts, kw, f"{tag}-path {mode}")
    # Bytes: six channels in and five out up to each watermark, the field
    # windows in, the J windows and displacements out; e bytes a value.
    e = p.x.element_size()
    sb = 6 * e
    n_wm = int(counts.sum())
    win = T * (t.tile_ny + 2 * deck.guard) * (t.tile_nx + 2 * deck.guard)
    numbers["advance"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: advance_kernel(p, ft, counts, **kw), 5),
        plain_ms=cuda_ms(lambda: advance_plain(p, ft, counts, **kw), 2),
        fused_ms=fused_ms, **bound(e * (11 * n_wm + 9 * win + T),
                                   ADVANCE_OPS_PER_PARTICLE * _live(p),
                                   f64=f64))
    # The same work with each bucket's live slots in random order: a warp's
    # lanes then hold up to 32 bases.
    ps = _shuffle_slots(p, counts,
                        torch.Generator(device=dev).manual_seed(3))
    err_s = _compare(ps, ft, counts, kw,
                     f"{tag}-path shape, shuffled slots")
    shuffled_ms = cuda_ms(lambda: advance_kernel(ps, ft, counts, **kw), 5)
    numbers["advance"]["shuffled_ms"] = shuffled_ms
    nyg, nxg = t.tile_ny + 2 * deck.guard, t.tile_nx + 2 * deck.guard
    print(f"{tag}: advance at the main path's final state "
          f"{numbers['advance']['ms']:.3f} ms, with its slots shuffled "
          f"{shuffled_ms:.3f} ms (max abs err {err_s:.3e}); bound "
          f"{numbers['advance']['bound_ms']:.3f} ms "
          f"({numbers['advance']['bound_by']}); "
          f"{advance_kernel.blocks_per_sm(2, mode, nyg, nxg)} blocks of "
          f"256 threads per SM [{card}]")
    if not f64:
        # B1's f32 mode on the same state (the f32 decks' deposit): its
        # time in lattice order and with the slots shuffled, beside its
        # bound (the int8 mode's bytes and operations).
        k32 = dict(kw, mode="f32")
        v32 = dict(max_abs_err=max(
            _compare(p, ft, counts, k32, f"{tag}-path shape o2 f32"),
            _compare(ps, ft, counts, k32, f"{tag}-path shape o2 f32, "
                     "shuffled slots")))
        v32.update(
            ms=cuda_ms(lambda: advance_kernel(p, ft, counts, **k32), 5),
            shuffled_ms=cuda_ms(lambda: advance_kernel(ps, ft, counts, **k32),
                                5),
            plain_ms=cuda_ms(lambda: advance_plain(p, ft, counts, **k32), 1),
            **bound(e * (11 * n_wm + 9 * win + T),
                    ADVANCE_OPS_PER_PARTICLE * _live(p)))
        numbers["advance"]["f32"] = v32
        print(f"{tag}: advance in its f32 mode at the main path's final "
              f"state {v32['ms']:.3f} ms, with its slots shuffled "
              f"{v32['shuffled_ms']:.3f} ms, plain {v32['plain_ms']:.3f} ms, "
              f"bound {v32['bound_ms']:.3f} ms ({v32['bound_by']}), max abs "
              f"err {v32['max_abs_err']:.3e}; "
              f"{advance_kernel.blocks_per_sm(2, 'f32', nyg, nxg)} blocks of "
              f"256 threads per SM [{card}]")
    del ps
    if f64:
        # B1's f64 mode on a 64-tile subset of this state (the first row
        # of tiles, with their origins), and its continuity residual.
        sub = type(p)(*(a[:SUBSET_TILES].contiguous() for a in p))
        fsub = type(ft)(*(a[:SUBSET_TILES].contiguous() for a in ft))
        origins = tuple(o[:SUBSET_TILES].contiguous()
                        for o in kw["origins"])
        skw = dict(kw, origins=origins)
        serr = _compare(sub, fsub, live_watermark(sub.w), skw,
                        f"{tag} 64-tile subset")
        cont = _continuity(deck, sub, mode, fsub, origins)
        print(f"{tag}: advance on a 64-tile subset of the final state "
              f"({_live(sub)} particles): max abs err {serr:.3e}, "
              f"continuity residual {cont:.3e} of scale (bar "
              f"{F64_CONTINUITY})")
        check(cont < F64_CONTINUITY, f"{tag} continuity {cont}")
        del sub, fsub
    else:
        lo, hi = PARENT_ADVANCE_MS
        print(f"{tag}: the advance with its per-tile origin arrays "
              f"{numbers['advance']['ms']:.3f} ms beside the parent "
              f"kernel's {lo}-{hi} ms at this state (PERF.md, the same card "
              "model)")
    del ft

    mc = deck.mover_cap(cap)
    sc = deck.mover_seg_cap(mc)
    grid = dict(tile_cols=t.tile_cols, tile_ny=t.tile_ny, tile_nx=t.tile_nx)
    skw = dict(grid, b_cap=mc)
    got = rb.split_kernel(p, **skw)
    want = rb.split_buckets_plain(p, **skw)
    err = max(_same(a, b, f"{tag} split {i}")
              for i, (a, b) in enumerate(zip(got, want)))
    numbers["split"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: rb.split_kernel(p, **skw), 3),
        plain_ms=cuda_ms(lambda: rb.split_buckets_plain(p, **skw), 1),
        **bound(2 * sb * T * cap + sb * T * mc + 8 * T))
    p1, movers, wm, pending = got
    del want
    gkw = dict(tile_rows=t.tile_rows, **grid, b_seg=sc)
    seg, sd = rb.segment_kernel(movers, **gkw)
    seg_p, sd_p = rb.segment_movers_plain(movers, **gkw)
    err = max(_same(seg, seg_p, f"{tag} segment"),
              _same(sd, sd_p, f"{tag} segment dropped"))
    numbers["segment"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: rb.segment_kernel(movers, **gkw), 3),
        plain_ms=cuda_ms(lambda: rb.segment_movers_plain(movers, **gkw), 1),
        **bound(sb * T * mc + sb * T * 8 * sc + 4 * T))
    del seg_p
    nbr = rb.seg_neighbor_table(t.tile_rows, t.tile_cols, dev)
    n_in = int((seg.w > 0).sum())
    # The appends read the runs' w, the live arrivals, the watermarks (and
    # the table), and write the arrivals and the dropped counts.
    app_bytes = e * T * 8 * sc + 2 * sb * n_in + 8 * T
    want, want_d = rb.append_segments_plain(p1, seg, wm, nbr, b_seg=sc)
    q = _clone(p1)
    got_d = rb.append_kernel(q, seg, wm, nbr, b_seg=sc)
    err = max(_same(q, want, f"{tag} append"),
              _same(got_d, want_d, f"{tag} append dropped"))
    # The append is idempotent on its own output (same runs, same
    # watermarks), so repeated launches time it fairly.
    numbers["append"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: rb.append_kernel(q, seg, wm, nbr, b_seg=sc), 3),
        plain_ms=cuda_ms(lambda: rb.append_segments_plain(
            p1, seg, wm, nbr, b_seg=sc), 1),
        **bound(app_bytes + 32 * T))
    inc = rb.roll_segments(seg, nbr, sc)
    r = _clone(p1)
    got_d = rb.append_runs_kernel(r, inc, wm, b_seg=sc)
    err = max(_same(r, want, f"{tag} append_runs"),
              _same(got_d, want_d, f"{tag} append_runs dropped"),
              _same(r, q, f"{tag} append_runs against the append"))
    numbers["append_runs"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: rb.append_runs_kernel(r, inc, wm, b_seg=sc), 3),
        plain_ms=cuda_ms(lambda: rb.append_runs_plain(p1, inc, wm,
                                                      b_seg=sc), 1),
        **bound(app_bytes))
    del want, q, r
    want, want_c, want_d = rb.defrag_buckets_plain(p1, inc)
    q = _clone(p1)
    got_c, got_d = rb.defrag_kernel(q, seg, nbr, b_seg=sc)
    err = max(_same(q, want, f"{tag} defrag"),
              _same(got_c, want_c, f"{tag} defrag counts"),
              _same(got_d, want_d, f"{tag} defrag dropped"))
    # Timed on a copy of the split buckets per launch: a second merge
    # into its own output would not be the same work.
    qs = [_clone(p1) for _ in range(3)]
    it = iter(qs)
    numbers["defrag"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: rb.defrag_kernel(next(it), seg, nbr, b_seg=sc), 2,
                   warm=1),
        plain_ms=cuda_ms(lambda: rb.defrag_buckets_plain(p1, inc), 1),
        **bound(2 * sb * T * cap + e * T * 8 * sc + sb * n_in + 32 * T
                + 8 * T))
    del want, q, qs, inc

    got = rb.extract_kernel(p, **skw)
    want = rb.extract_movers_plain(p, **skw)
    err = max(_same(a, b, f"{tag} extract {i}")
              for i, (a, b) in enumerate(zip(got, want)))
    n_ext = _live(want[1])
    numbers["extract"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: rb.extract_kernel(p, **skw), 3),
        plain_ms=cuda_ms(lambda: rb.extract_movers_plain(p, **skw), 1),
        **bound(3 * e * T * cap + 3 * e * n_ext + e * T * cap + sb * T * mc
                + 8 * T))
    print(f"{tag}: extract: {n_ext} movers out, {int(want[3].sum())} not "
          "kept: equal")
    del got, want

    # The copy kernels last about as long as their wrappers take on the
    # host: their device time is measured at the end (device_times).
    # Both write the same arrivals at the same watermarks into one copy.
    q = _clone(p1)
    inc = rb.roll_segments(seg, nbr, sc)
    jobs = [(lambda: rb.append_kernel(q, seg, wm, nbr, b_seg=sc), 5,
             "append_kernel"),
            (lambda: rb.append_runs_kernel(q, inc, wm, b_seg=sc), 5,
             "append_rows_kernel")]

    fused_out = rebin_auto(p, t, mc, seg_cap=sc)
    rb.append_runs_kernel.reset()
    runs_out = rebin_auto(p, t, mc, seg_cap=sc, fused=False)
    runs_launches = rb.append_runs_kernel.launches
    _same(runs_out[0], fused_out[0], f"{tag} rebin_auto fused=False")
    check(int(runs_out[1]) == int(fused_out[1])
          and int(runs_out[2]) == int(fused_out[2]),
          f"{tag} rebin_auto fused=False counts")
    del fused_out, runs_out
    auto_ms = cuda_ms(lambda: rebin_auto(p, t, mc, seg_cap=sc), 3)
    unfused_ms = cuda_ms(lambda: rebin_auto(p, t, mc, seg_cap=sc,
                                            fused=False), 3)
    sort_ms = cuda_ms(lambda: rebin(p, t), 3)
    for name, v in numbers.items():
        print(f"{tag}: {name} at the main path's shape: kernel "
              f"{v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, bound "
              f"{v['bound_ms']:.3f} ms ({v['bound_by']}), max abs err "
              f"{v['max_abs_err']:.3e} [{card}]")
    print(f"{tag}: advance kernel {numbers['advance']['ms']:.3f} ms = "
          f"{_live(p) / (numbers['advance']['ms'] / 1e3):.4e} "
          f"pushes/s alone; deal-route re-bin (rebin_auto) {auto_ms:.3f} ms, "
          f"through append_runs (fused=False, equal) {unfused_ms:.3f} ms, "
          f"sort re-bin {sort_ms:.3f} ms; split buffer {mc}, runs {sc}, "
          f"{int(pending.sum())} pending [{card}]")

    # rebin_incremental, the extract's path, on a copy of the final state:
    # extract, route, append_incoming.
    for k in rb.KERNELS.values():
        k.reset()
    n0 = _live(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, dropped, wm_after = rebin_incremental(_clone(p), t, mc)
    torch.cuda.synchronize()
    inc_ms = (time.perf_counter() - t0) * 1e3
    inc_launches = {n: k.launches for n, k in rb.KERNELS.items()}
    check(inc_launches["extract"] == 1
          and inc_launches["append_incoming"] == 1,
          f"rebin_incremental launches {inc_launches}")
    check(_live(p2) + int(dropped) == n0, "rebin_incremental lost particles")
    check(all(bool(torch.isfinite(a).all()) for a in p2),
          "rebin_incremental: particles not finite")
    print(f"{tag}: rebin_incremental on the final state: {inc_ms:.3f} ms "
          f"(host clock, first call), dropped {int(dropped)}, max watermark "
          f"{int(wm_after)} of {cap}, launches extract "
          f"{inc_launches['extract']}, append_incoming "
          f"{inc_launches['append_incoming']} [{card}]")
    launches["extract"] = inc_launches["extract"]
    launches["append_runs"] = runs_launches
    out = {n: dict(launches=launches[n], **v) for n, v in numbers.items()}
    out.update({f"{n}_launches": c for n, c in diag_launches.items()})
    return out, jobs


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


# The command line (the cli phase): the port's CLI driven in-process into a
# git-ignored folder of this checkout, removed at the end.
# The multi-device simulations (parallel/): every shard on this card.  The
# twins' steps (the decks' drift trigger fires near step 22), the window
# twin's cut and steps (two shifts), the
# load_balance decks' history cadence (one read a record), the bunching
# deck's steps (cut from 3,394: 900 carry the blob, at ~0.45 c, across a
# 12.8-unit shard seam), the skew bars of tests/test_balanced.py:184-187,
# and the balanced CLI run's cut and split.
MESH_TWIN_STEPS = 30
MESH_WINDOW_TWIN = (dict(nx=64, ny=32), 47)
LB_RECORD_EVERY = 25
BUNCHING_STEPS = 900
SKEW_BLOCK_ABOVE = 1.5
SKEW_STRIPE_BELOW = 1.10
CLI_BALANCED = ("load_balance_bunching", dict(nx=128, ny=128), 40)


def _mesh_live(sim) -> int:
    return sum(_live(p) for sp in sim.shard_state.species for p in sp)


def phase_sharded_kernels(dev) -> None:
    """B1, B2 and B3 in the multi-device simulations' tile coordinates, each
    against its plain version on the 64-tile subsets (an 8x8 grid of the
    headline's 8x8 tiles): the block of shard (1, 1) of a (2, 2) mesh
    (rows and columns 4-7: row0 = col0 = 4) and the stripe of shard 3 of
    8 (its gids).  B1 in int8 and f32 on shuffled slots; the split with
    row0/col0 and with tile_ids; the segment of the blocks at (4, 4) and
    (0, 0) with the global grid's fold, its movers through every seam and
    corner of the block and, at its far edges, through the grid's wrap."""
    import itertools

    import torch

    from minipic_torch.ops import rebin as rb
    from minipic_torch.ops.advance import live_watermark
    from minipic_torch.parallel.balanced import stripe_gids

    def block(r0, c0):
        return [(r0 + i) * 8 + c0 + j for i in range(4) for j in range(4)]

    stripe = [int(g) for g in stripe_gids(8, 8, 8)[3]]
    layouts = (("block (4, 4)", block(4, 4)), ("stripe 3 of 8", stripe))
    for (label, gids), mode in itertools.product(layouts, ("int8", "f32")):
        deck, p, ft = _subset(2, dev, "shuffled")
        idx = torch.tensor(gids, device=dev)
        sub = type(p)(*(a[idx].contiguous() for a in p))
        fsub = type(ft)(*(a[idx].contiguous() for a in ft))
        g32 = idx.to(torch.int32)
        kw = dict(_kw(deck, mode, dev),
                  origins=((g32 % 8) * 8, (g32 // 8) * 8))
        err = _compare(sub, fsub, live_watermark(sub.w), kw,
                       f"sharded advance {label} {mode}")
        print(f"sharded kernels: advance, {label}, {mode}: {_live(sub)} "
              f"particles in {len(gids)} tiles with their global origins, "
              f"max abs err {err:.3e}")
    deck, cap, p = _rebin_subset(dev)
    mc = deck.mover_cap(cap)
    sc = deck.mover_seg_cap(mc)
    for label, gids, kw in (
            ("block (4, 4)", block(4, 4), dict(tile_cols=4, row0=4, col0=4)),
            ("stripe 3 of 8", stripe, dict(tile_cols=8, tile_ids=torch.tensor(
                stripe, dtype=torch.int32, device=dev)))):
        idx = torch.tensor(gids, device=dev)
        sub = type(p)(*(a[idx].contiguous() for a in p))
        kw.update(tile_ny=8, tile_nx=8, b_cap=mc)
        got = rb.split_kernel(sub, **kw)
        want = rb.split_buckets_plain(sub, **kw)
        err = max(_same(a, b, f"sharded split {label} {i}")
                  for i, (a, b) in enumerate(zip(got, want)))
        n_mov = _live(got[1])
        check(n_mov > 0, f"sharded split {label}: no movers")
        print(f"sharded kernels: split, {label}: {n_mov} movers of "
              f"{_live(sub)} particles, equal to its plain version (max abs "
              f"err {err:.1e})")
    for r0, c0 in ((4, 4), (0, 0)):
        idx = torch.tensor(block(r0, c0), device=dev)
        sub = type(p)(*(a[idx].contiguous() for a in p))
        skw = dict(tile_cols=4, tile_ny=8, tile_nx=8, row0=r0, col0=c0)
        _, movers, _, _ = rb.split_buckets_plain(sub, b_cap=mc, **skw)
        gkw = dict(skw, tile_rows=4, b_seg=sc, grid_rows=8, grid_cols=8)
        seg, sd = rb.segment_kernel(movers, **gkw)
        seg_p, sd_p = rb.segment_movers_plain(movers, **gkw)
        err = max(_same(seg, seg_p, f"sharded segment ({r0}, {c0})"),
                  _same(sd, sd_p, f"sharded segment ({r0}, {c0}) dropped"))
        runs = (seg.w.reshape(16, 8, sc) > 0).sum(dim=(0, 2))
        # Movers leaving the block: destination tile outside rows/columns
        # r0..r0+3 / c0..c0+3 (through a seam, or the grid's wrap).
        t = torch.arange(16, device=dev)[:, None]
        col = torch.floor(movers.x / 8) - (c0 + t % 4)
        row = torch.floor(movers.y / 8) - (r0 + t // 4)
        live = movers.w > 0
        out_col = live & ((t % 4 == 0) & (col != 0) & (col != 1)
                          | (t % 4 == 3) & (col != 0) & (col != -1))
        out_row = live & ((t // 4 == 0) & (row != 0) & (row != 1)
                          | (t // 4 == 3) & (row != 0) & (row != -1))
        check(bool((runs > 0).all()) and int(sd.sum()) == 0
              and int(out_col.sum()) > 0 and int(out_row.sum()) > 0,
              f"sharded segment ({r0}, {c0}): runs {runs.tolist()}, "
              f"dropped {int(sd.sum())}")
        print(f"sharded kernels: segment, block ({r0}, {c0}) of the 8x8 "
              f"grid: {_live(movers)} movers, every direction's run "
              f"non-empty ({runs.tolist()}), {int(out_col.sum())} / "
              f"{int(out_row.sum())} leaving the block through a column / "
              "row seam, none dropped; equal to its plain version (max abs "
              f"err {err:.1e})")


def _twin_deck(**kw):
    """tests/test_parallel.py:84-100's deck in f32 with the int8 deposit and
    guard 4 (test_parallel.py:171-180)."""
    from minipic_torch.core import config as cfg

    base = dict(
        box_x=8.0, box_y=8.0, nx=64, ny=64, tile_nx=8, tile_ny=8, guard=4,
        deposit="int8", species=(
            cfg.SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=4, ux=0.3,
                            uy=0.2, uth=0.05),
            cfg.SpeciesSpec("ion", charge=+1.0, mass=5.0, ppc=4, ux=-0.1,
                            uth=0.02)))
    base.update(kw)
    return cfg.Deck(**base)


def _twin(label, ref, sim, steps, fe_rtol, ke_rtol):
    """Steps `ref` (Simulation) and `sim` (a mesh simulation) from the same
    load: field and kinetic energies within the bars, live counts exact,
    overflow 0 on every step.  Returns the mesh simulation's kernel
    launches."""
    from minipic_torch.ops import rebin as rb
    from minipic_torch.ops.advance import advance_kernel

    advance_kernel.launches = 0
    for k in rb.KERNELS.values():
        k.reset()
    # Launches of the mesh simulation only: the reference steps with the
    # counters saved and put back.
    counts = {n: 0 for n in ("advance", *rb.KERNELS)}

    def read():
        return dict(advance=advance_kernel.launches,
                    **{n: k.launches for n, k in rb.KERNELS.items()})

    rebins = 0
    for i in range(steps):
        before = read()
        dm = sim.step()
        after = read()
        for n in counts:
            counts[n] += after[n] - before[n]
        dr = ref.step()
        fe = (float(dm.field_energy), float(dr.field_energy))
        check(abs(fe[0] - fe[1]) <= fe_rtol * abs(fe[1]) + 1e-12,
              f"{label} step {i}: field energy {fe}")
        km, kr = dm.kinetic_energy.cpu(), dr.kinetic_energy.cpu()
        check(bool(((km - kr).abs() <= ke_rtol * kr.abs()
                    + 1e-7 * float(kr.sum())).all()),
              f"{label} step {i}: kinetic energy {km} vs {kr}")
        check(int(dm.shard_live.sum()) == int(dr.shard_live[0]),
              f"{label} step {i}: live {int(dm.shard_live.sum())} vs "
              f"{int(dr.shard_live[0])}")
        check(int(dm.overflow) == 0 and int(dr.overflow) == 0
              and dm.rebinned == dr.rebinned,
              f"{label} step {i}: overflow or re-bin differs")
        rebins += dm.rebinned
    check(rebins >= 1, f"{label}: no re-bin")
    return fe, rebins, counts


def phase_mesh_twins(dev, card: str) -> None:
    """ShardedSimulation at (2, 2) and (2, 4) and BalancedSimulation over 8
    shards, every shard on this card, against Simulation on it, from the
    same load: tests/test_parallel.py:84's deck in f32 with the int8 deposit
    and guard 4, and its deal-route variant (test_parallel.py:268-279,
    appended fused and through append_runs), held to the JAX package's f32
    bars for this comparison (test_parallel.py:293-299: field energy rtol
    1e-5, kinetic 1e-6), live counts exact, overflow 0; then
    laser_wakefield_window cut to 64x32 (tests/test_decks_cli.py:96-105),
    sharded and striped, through two shifts (the open decks' twin bars)."""
    from minipic_torch.core import config as cfg
    from minipic_torch.decks import standard
    from minipic_torch.parallel.balanced import BalancedSimulation
    from minipic_torch.parallel.step import ShardedSimulation
    from minipic_torch.simulation import Simulation, bucket_capacity

    # The deal-route variant as test_parallel.py:268-279 has it: guard 2
    # and the f32 deposit (guard 4's larger drift budget sizes the runs
    # past the 2304-slot buckets' gate).
    deal = dict(rebin_mode="incremental", kchunk=64, capacity_headroom=3.0,
                guard=2, deposit="",
                species=(cfg.SpeciesSpec("ele", charge=-1.0, mass=1.0,
                                         ppc=12, ux=0.3, uy=0.2, uth=0.05),))
    runs = (("sharded (2, 2)", dict(mesh_shape=(2, 2)), "sharded"),
            ("sharded (2, 4)", dict(mesh_shape=(2, 4)), "sharded"),
            ("striped 8", {}, "balanced"),
            ("deal route sharded (2, 2)", dict(mesh_shape=(2, 2), **deal),
             "sharded"))
    for label, kw, layout in runs:
        deck = _twin_deck(**kw)
        ref = Simulation(deck, seed=7, device=dev)
        if layout == "sharded":
            r, c = deck.mesh_shape
            sim = ShardedSimulation(deck, seed=7, devices=[dev] * (r * c))
        else:
            sim = BalancedSimulation(deck, seed=7, devices=[dev] * 8)
        check(sim.mesh.distinct() == [dev], f"{label}: mesh devices "
              f"{sim.mesh.distinct()}")
        if "deal" in label:
            cap = bucket_capacity(deck)
            sc = deck.mover_seg_cap(deck.mover_cap(cap))
            check(sc > 0 and cap >= 8 * sc + 256,
                  f"{label}: the deal route does not engage")
        fe, rebins, counts = _twin(label, ref, sim, MESH_TWIN_STEPS, 1e-5,
                                   1e-6)
        n_sp = len(deck.species)
        check(counts["advance"] == MESH_TWIN_STEPS * n_sp * sim.mesh.size,
              f"{label}: advance launches {counts['advance']}")
        check(counts["split"] == rebins * n_sp * sim.mesh.size,
              f"{label}: split launches {counts['split']}")
        if "deal" in label:
            check(counts["segment"] == counts["append"] == counts["split"],
                  f"{label}: launches {counts}")
        print(f"mesh twins: {label}, {sim.mesh.size} shards on {dev}: "
              f"{MESH_TWIN_STEPS} steps match Simulation on the card (field "
              f"energy {fe[0]:.9e} vs {fe[1]:.9e}, {rebins} re-bins); "
              f"launches {counts} [{card}]")
    name, (kw, steps) = "laser_wakefield_window", MESH_WINDOW_TWIN
    case = standard.make(name, **kw)
    for layout in ("sharded", "balanced"):
        ref = case.simulation(seed=1, device=dev)
        sim = case.simulation(seed=1, device=dev, layout=layout,
                              devices=[dev] * 8)
        label = f"{name} {kw['nx']}x{kw['ny']} {layout}"
        fe, rebins, counts = _twin(label, ref, sim, steps, 1e-4, 1e-5)
        w0 = (sim.shard_state.window_x0, int(ref.state.window_x0))
        check(w0[0] == w0[1] == 2 * case.deck.tile_nx,
              f"{label}: window_x0 {w0}")
        print(f"mesh twins: {label}, mesh {sim.mesh.shape}: {steps} steps "
              f"match Simulation through two shifts (field energy "
              f"{fe[0]:.6e} vs {fe[1]:.6e}, {rebins} re-bins, window_x0 "
              f"{w0[0]}); launches {counts} [{card}]")


def _mesh_run(sim, steps: int, label: str, card: str, dev) -> dict:
    """`steps` of sim.run_step, timed (host clock around
    torch.cuda.synchronize()), with every launch counter at 0 before and
    read after, the history recorded every LB_RECORD_EVERY steps (one read
    a record); checks the live count conserved exactly on these periodic
    decks (less each counted drop), each drop followed at once by growth,
    and the re-bins through the kernels.  Returns the run's numbers."""
    import torch

    from minipic_torch.diag.history import RunHistory
    from minipic_torch.ops import rebin as rb
    from minipic_torch.ops.advance import advance_kernel

    deck = sim.deck
    n0 = _mesh_live(sim) if hasattr(sim, "shard_state") else sum(
        _live(p) for p in sim.state.species)
    advance_kernel.launches = 0
    for k in rb.KERNELS.values():
        k.reset()
    hist = RunHistory()
    drop_steps, rebins, ovf = 0, 0, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        d = sim.run_step(i)
        rebins += d.rebinned
        if sim.overflow_total > ovf:
            drop_steps += 1
            ovf = sim.overflow_total
        if i % LB_RECORD_EVERY == 0 or i == steps:
            hist.record(i, deck.dt, d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(advance=advance_kernel.launches,
                    **{n: k.launches for n, k in rb.KERNELS.items()})
    live = _mesh_live(sim) if hasattr(sim, "shard_state") else sum(
        _live(p) for p in sim.state.species)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    shards = sim.mesh.size if hasattr(sim, "mesh") else 1
    n_sp = len(deck.species)
    caps = ([p.capacity for p in sim.shard_state.species[0]]
            if hasattr(sim, "shard_state")
            else [p.capacity for p in sim.state.species])
    skew = hist.live_skew
    print(f"load balance: {label}: {steps} steps in {wall:.2f} s, "
          f"{1e3 * wall / steps:.4f} ms/step, {rebins} re-bins, overflow "
          f"{sim.overflow_total} in {drop_steps} steps, {sim.capacity_changes}"
          f" capacity changes (buckets {caps}), live {live} (was {n0}), "
          f"peak {peak:.2f} GB, live skew (max/mean of shard_live) first "
          f"{skew[0]:.4f} last {skew[-1]:.4f} min {min(skew):.4f} max "
          f"{max(skew):.4f}, kernel launches {launches} "
          f"({sum(launches.values()) / steps:.1f} a step) [{card}]")
    check(all(math.isfinite(e) for e in hist.field_energy),
          f"{label}: field energy not finite")
    check(live + sim.overflow_total == n0,
          f"{label}: live {live} + dropped {sim.overflow_total} != {n0}")
    check(drop_steps <= sim.capacity_changes,
          f"{label}: {drop_steps} steps dropped, {sim.capacity_changes} "
          "capacity changes")
    check(launches["advance"] == steps * n_sp * shards,
          f"{label}: advance launches {launches['advance']}")
    check(launches["split"] == rebins * n_sp * shards
          and launches["defrag"] == launches["split"]
          and launches["append"] == launches["segment"]
          and launches["segment"] + launches["append_incoming"]
          == launches["split"], f"{label}: re-bin launches {launches}")
    check(rebins >= 1, f"{label}: no re-bin")
    return dict(ms_per_step=1e3 * wall / steps, steps=steps, rebins=rebins,
                overflow=sim.overflow_total, live=live, peak_gb=peak,
                skew_last=skew[-1], skew_min=min(skew), skew_max=max(skew),
                launches=launches)


def _shard_kernel_numbers(sim, card: str) -> dict:
    """B1, B2 and B3 at load_balance_stress's final state, on shard 5 (mesh
    row 1, column 1: offsets 32, 32 on the 128x128 tile grid), electrons:
    each against its plain version, timed (CUDA events), with its bound."""
    import torch

    from minipic_torch.fields.tiles import extract_field_tiles
    from minipic_torch.ops import rebin as rb
    from minipic_torch.ops.advance import (advance_kernel, advance_plain,
                                           live_watermark)
    from minipic_torch.parallel.halo import exchange_halo
    from minipic_torch.parallel.mesh import local_tile_grid
    from minipic_torch.simulation import rebin_caps, tile_origins
    from minipic_torch.core.state import FieldState

    deck, mesh, st = sim.deck, sim.mesh, sim.shard_state
    s = 5
    r, c = mesh.coords(s)
    ltr, ltc = local_tile_grid(deck, mesh)
    t = deck.tiling
    g = deck.guard
    padded = exchange_halo([torch.stack(tuple(f)) for f in st.fields], g,
                           mesh)[s]
    ft = extract_field_tiles(FieldState(*padded.unbind(0)), ltr, ltc,
                             t.tile_ny, t.tile_nx, g)
    p = st.species[s][0]
    T, cap = p.x.shape
    spec = deck.species[0]
    kw = dict(qm=spec.charge / spec.mass, q=spec.charge,
              order=spec.shape_order, tile_ny=t.tile_ny, tile_nx=t.tile_nx,
              origins=tile_origins(t, p.x.device, r * ltr, c * ltc, ltr,
                                   ltc), g=g, dt=deck.dt, dx=deck.dx,
              dy=deck.dy, grid=(deck.nx, deck.ny), mode="f32")
    counts = live_watermark(p.w)
    label = f"load_balance_stress shard {s} (mesh {r}, {c})"
    err = _compare(p, ft, counts, kw, f"{label} advance")
    n_wm = int(counts.sum())
    win = T * (t.tile_ny + 2 * g) * (t.tile_nx + 2 * g)
    shape = f"{T} tiles x {cap} slots"
    out = dict(advance=dict(
        shape=shape, max_abs_err=err,
        ms=cuda_ms(lambda: advance_kernel(p, ft, counts, **kw), 5),
        plain_ms=cuda_ms(lambda: advance_plain(p, ft, counts, **kw), 1),
        **bound(4 * (11 * n_wm + 9 * win + T),
                ADVANCE_OPS_PER_PARTICLE * _live(p))))
    mc, sc = rebin_caps(deck, cap)
    skw = dict(tile_cols=ltc, tile_ny=t.tile_ny, tile_nx=t.tile_nx, b_cap=mc,
               row0=r * ltr, col0=c * ltc)
    got = rb.split_kernel(p, **skw)
    want = rb.split_buckets_plain(p, **skw)
    out["split"] = dict(
        shape=f"{shape}, mover buffer {mc}",
        max_abs_err=max(_same(a, b, f"{label} split {i}")
                        for i, (a, b) in enumerate(zip(got, want))),
        ms=cuda_ms(lambda: rb.split_kernel(p, **skw), 5),
        plain_ms=cuda_ms(lambda: rb.split_buckets_plain(p, **skw), 1),
        **bound(2 * 24 * T * cap + 24 * T * mc + 8 * T))
    movers = got[1]
    gkw = dict(tile_rows=ltr, tile_cols=ltc, tile_ny=t.tile_ny,
               tile_nx=t.tile_nx, b_seg=sc, row0=r * ltr, col0=c * ltc,
               grid_rows=t.tile_rows, grid_cols=t.tile_cols)
    seg, sd = rb.segment_kernel(movers, **gkw)
    seg_p, sd_p = rb.segment_movers_plain(movers, **gkw)
    out["segment"] = dict(
        shape=f"{T} tiles, mover buffer {mc}, runs {sc}",
        max_abs_err=max(_same(seg, seg_p, f"{label} segment"),
                        _same(sd, sd_p, f"{label} segment dropped")),
        ms=cuda_ms(lambda: rb.segment_kernel(movers, **gkw), 5),
        plain_ms=cuda_ms(lambda: rb.segment_movers_plain(movers, **gkw), 1),
        **bound(24 * T * mc + 24 * T * 8 * sc + 4 * T))
    for name, v in out.items():
        print(f"load balance: {name} at {label}'s final state, electrons "
              f"({v['shape']}, {_live(p)} live): kernel {v['ms']:.4f} ms, "
              f"plain {v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']}), max abs err {v['max_abs_err']:.2e} "
              f"[{card}]")
    return out


def phase_load_balance(dev, card: str) -> dict:
    """The three load_balance decks at their default sizes on the (2, 4)
    mesh, all eight shards on this card, through the simulations' run_step:
    load_balance_stress sharded (its 282 steps), then B1-B3 timed at one
    shard of its final state; load_balance_stress_counts sharded, striped
    and through Simulation (282 steps each), the skew bars held;
    load_balance_bunching sharded and striped, cut to BUNCHING_STEPS.
    Returns B1-B3's numbers at the stress deck's shard, and the kernels'
    launches in each run."""
    import gc

    import torch

    from minipic_torch.decks import standard

    t_phase = time.perf_counter()
    runs = {}
    case = standard.make("load_balance_stress")
    deck = case.deck
    t0 = time.perf_counter()
    sim = case.simulation(seed=0, device=dev, layout="sharded")
    torch.cuda.synchronize()
    check(sim.mesh.shape == (2, 4) and sim.mesh.distinct() == [dev],
          f"load_balance_stress: mesh {sim.mesh.shape} on "
          f"{sim.mesh.distinct()}")
    n = _mesh_live(sim)
    print(f"load balance: load_balance_stress {deck.nx}^2, 2 species, "
          f"{n} particles ({n // 2} a species), buckets "
          f"{sim.shard_state.species[0][0].capacity} slots, f32 deposit, "
          f"mesh {sim.mesh.shape}: loaded in {time.perf_counter() - t0:.1f} "
          "s")
    runs["stress sharded"] = _mesh_run(sim, deck.total_steps,
                                       "load_balance_stress sharded", card,
                                       dev)
    check(runs["stress sharded"]["launches"]["segment"] > 0,
          "load_balance_stress: the deal route did not run")
    numbers = _shard_kernel_numbers(sim, card)
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    case = standard.make("load_balance_stress_counts")
    for layout in ("sharded", "balanced", "single"):
        sim = case.simulation(seed=0, device=dev, layout=layout)
        label = f"load_balance_stress_counts {layout}"
        runs[f"counts {layout}"] = _mesh_run(sim, case.deck.total_steps,
                                             label, card, dev)
        del sim
        gc.collect()
        torch.cuda.empty_cache()
    blk, stp = runs["counts sharded"], runs["counts balanced"]
    check(blk["skew_min"] > SKEW_BLOCK_ABOVE,
          f"counts: block skew {blk['skew_min']} not above "
          f"{SKEW_BLOCK_ABOVE}")
    check(stp["skew_max"] < SKEW_STRIPE_BELOW,
          f"counts: striped skew {stp['skew_max']} not below "
          f"{SKEW_STRIPE_BELOW}")
    print(f"load balance: load_balance_stress_counts skew over the run: "
          f"block {blk['skew_min']:.4f}-{blk['skew_max']:.4f} (bar > "
          f"{SKEW_BLOCK_ABOVE}), striped {stp['skew_min']:.4f}-"
          f"{stp['skew_max']:.4f} (bar < {SKEW_STRIPE_BELOW}); ms/step "
          f"sharded {blk['ms_per_step']:.3f}, striped "
          f"{stp['ms_per_step']:.3f}, single device "
          f"{runs['counts single']['ms_per_step']:.3f} [{card}]")
    case = standard.make("load_balance_bunching")
    print(f"load balance: load_balance_bunching cut from "
          f"{case.deck.total_steps} to {BUNCHING_STEPS} steps")
    for layout in ("sharded", "balanced"):
        sim = case.simulation(seed=0, device=dev, layout=layout)
        runs[f"bunching {layout}"] = _mesh_run(
            sim, BUNCHING_STEPS, f"load_balance_bunching {layout}", card, dev)
        del sim
        gc.collect()
        torch.cuda.empty_cache()
    print(f"load balance: the phase took {time.perf_counter() - t_phase:.1f}"
          " s")
    return numbers, {k: v["launches"] for k, v in runs.items()}


def _cli_mesh(tmp: Path, card: str) -> None:
    """The multi-device simulations through the CLI: load_balance_stress_counts
    --sharded for 20 steps at its full size, and load_balance_bunching cut
    to 128^2 --balanced, straight for CLI_BALANCED's steps and stopped half
    way and resumed, held to the straight runs (``_resumed_within_spread``)."""
    from minipic_torch.ops.advance import advance_kernel

    r = _cli(["--deck", "load_balance_stress_counts", "--sharded", "--steps",
              20, "--save-every", 10, "--no-save", "--out",
              tmp / "counts"], "load_balance_stress_counts --sharded", card)
    check(r["overflow"] == 0 and advance_kernel.launches == 20 * 2 * 8,
          f"cli: counts --sharded: overflow {r['overflow']}, advance "
          f"launches {advance_kernel.launches}")
    name, kw, steps = CLI_BALANCED
    base = ["--deck", name, "--nx", kw["nx"], "--ny", kw["ny"], "--balanced",
            "--save-every", steps // 2, "--no-save"]
    label = f"{name} {kw['nx']}^2 --balanced"
    for k in "ACD":
        _cli(base + ["--steps", steps, "--out", tmp / f"bal_{k}"],
             f"{label} straight {k}", card)
    _cli(base + ["--steps", steps // 2, "--out", tmp / "bal_B"],
         f"{label} to {steps // 2}", card)
    _cli(base + ["--steps", steps, "--out", tmp / "bal_B", "--resume"],
         f"{label} resumed", card)
    ck = {k: _checkpoint(tmp / f"bal_{k}") for k in "ABCD"}
    check(all(int(v["step"]) == steps for v in ck.values()),
          f"cli: {label}: final steps")
    live = {k: [int((v[f"sp{i}_w"] > 0).sum())
                for i in range(int(v["n_species"]))] for k, v in ck.items()}
    check(live["A"] == live["B"] == live["C"] == live["D"],
          f"cli: {label}: live counts {live}")
    # jz of the int8 deposit adds floats in any order across warps, so
    # straight runs may differ in the last bits: the spread rule.
    _resumed_within_spread(f"{label} stopped at {steps // 2}", ck, card)


CLI_DIR = ROOT / "_cli_smoke"
CLI_SAVE_EVERY = 425  # laser_plasma: four saves in its 1,697 steps
CLI_SPLIT = 850  # where the resumed laser_plasma run stops and restarts
CLI_PULSE_STEPS = 2500  # reference_pulse, cut from its 63,639 steps
CLI_PULSE_SAVE_EVERY = 25  # the reference's own cadence
# reference_pulse's runs through the CLI and through Simulation.run, taken in
# turn so that neither always runs first on a host that drifts.
CLI_PULSE_ORDER = ("cli", "run", "run", "cli", "cli", "run")
CLI_CHANNELS = ("x", "y", "px", "py", "pz", "w")
# What --resume is held to where uninterrupted card runs differ (int8's jz
# adds with atomics in any order, and the plasma amplifies the last bits): the resumed run may differ from the first by no more than
# CLI_SPREAD times the largest difference among three uninterrupted runs,
# field by field and channel by channel.  Between pairs of uninterrupted
# laser_plasma runs these differences vary up to 3x; a resume that lost
# state would differ by orders of magnitude.  Where the uninterrupted runs
# differ at all, a channel in which all three happen to agree may still
# differ by a rounding in a fourth run (load_balance_bunching's positions
# differ by one ulp between some pairs of straight runs and not others), so
# each channel's spread counts as at least one ulp of its largest value
# (``_rounding_units``).
CLI_SPREAD = 4.0


def _cli(args, label: str, card: str, n_species: int = 0) -> dict:
    """minipic_torch.cli.main(args) in this process, timed, with every launch
    counter at 0 before it; prints the CLI's own summary lines and returns
    its numbers (from its ``done:`` line) and the launches per kernel.
    With `n_species`, the advance must have launched once a step per
    species and every re-bin through the re-bin kernels
    (``_auto_route_launches``)."""
    import contextlib
    import io
    import re

    import torch

    from minipic_torch import cli
    from minipic_torch.ops import rebin as rb
    from minipic_torch.ops.advance import advance_kernel

    for k in rb.KERNELS.values():
        k.reset()
    advance_kernel.launches = 0
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    check(rc == 0, f"cli: {label}: exit code {rc}\n{out}")
    for line in out.splitlines():
        if line.startswith(("snapshot writer", "resumed", "done")):
            print(f"cli: {label}: {line}")
    m = re.search(r"done: (\d+) steps in ([\d.]+) s \(([\d.]+) ms/step\); "
                  r"(\d+) saves, ([\d.]+) ms a save, flush ([\d.]+) ms "
                  r"\(writer (.*?)\); overflow (\d+)", out)
    check(m is not None, f"cli: {label}: no summary line\n{out}")
    steps = int(m[1])
    if n_species:
        check(advance_kernel.launches == n_species * steps,
              f"cli: {label}: {advance_kernel.launches} advance launches in "
              f"{steps} steps")
        rebin = _auto_route_launches(f"cli: {label}", small_only=False)
    else:
        rebin = {n: k.launches for n, k in rb.KERNELS.items()}
    launches = dict(advance=advance_kernel.launches, **rebin)
    print(f"cli: {label}: {wall:.2f} s in the process, launches {launches} "
          f"[{card}]")
    return dict(steps=steps, run_s=float(m[2]), ms_per_step=float(m[3]),
                saves=int(m[4]), ms_per_save=float(m[5]),
                flush_ms=float(m[6]), writer=m[7], overflow=int(m[8]),
                wall_s=wall, launches=launches)


def _np_windows(comps, tiling, g: int):
    """[T, nyg, nxg, 6] f64 tile windows of numpy fields, assembled on the
    host as the JAX package's writer does (np.pad wrap, then slices)."""
    import numpy as np

    wins = []
    for c in comps:
        ap = np.pad(np.asarray(c, np.float64), g, mode="wrap")
        v = np.lib.stride_tricks.sliding_window_view(
            ap, (tiling.tile_ny + 2 * g, tiling.tile_nx + 2 * g))
        wins.append(v[::tiling.tile_ny, ::tiling.tile_nx].reshape(
            tiling.num_tiles, tiling.tile_ny + 2 * g, tiling.tile_nx + 2 * g))
    return np.stack(wins, axis=-1)


def _snapshot_buffers(state, deck, label: str, card: str) -> dict:
    """The card's part of a save: the tile windows cut on the card and
    copied once (io.hdf5.tile_windows) against a numpy assembly of the same
    fields, and the live particles compacted on the card and copied once
    (io.hdf5.particle_buffer) against a numpy compaction; both equal, and
    timed."""
    import numpy as np
    import torch

    from minipic_torch.io import hdf5

    f = state.fields
    want = _np_windows([c.cpu().numpy() for c in f], deck.tiling, deck.guard)
    got = hdf5.tile_windows(f, deck.tiling, deck.guard)
    check(got.shape == want.shape and np.array_equal(got, want),
          f"cli: {label}: the card's tile windows differ from numpy's")

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    out = dict(fields_ms=timed(lambda: hdf5.tile_windows(f, deck.tiling,
                                                         deck.guard)),
               fields_mb=got.nbytes / 1e6)
    if state.species:
        counts, flat = hdf5.particle_buffer(state.species)
        ref = []
        for p in state.species:
            w = p.w.cpu().numpy().ravel()
            ref += [getattr(p, c).cpu().numpy().ravel()[w > 0].astype(
                np.float64) for c in CLI_CHANNELS]
        check(np.array_equal(flat, np.concatenate(ref)),
              f"cli: {label}: the card's particle buffer differs from numpy's")
        out.update(particles_ms=timed(lambda: hdf5.particle_buffer(
            state.species)), particles_mb=flat.nbytes / 1e6, live=counts)
    print(f"cli: {label}: a save's part on the card (cut, compact, one copy "
          f"each), equal to numpy's: fields {out['fields_mb']:.1f} MB in "
          f"{out['fields_ms']:.3f} ms"
          + (f", particles {out['particles_mb']:.1f} MB ({out['live']} live)"
             f" in {out['particles_ms']:.3f} ms" if state.species else "")
          + f" [{card}]")
    return out


def _checkpoint(folder):
    import numpy as np

    with np.load(os.path.join(folder, "checkpoint.npz")) as z:
        return {k: z[k] for k in z.files}


def _identical(a: dict, b: dict) -> bool:
    """Two checkpoints equal bit for bit, array by array."""
    import numpy as np

    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def _state_diffs(a: dict, b: dict) -> dict:
    """Max |a - b| of two checkpoints: per field component, and per species
    and channel over the live particles sorted channel by channel (runs
    that diverge file their particles in other slots); inf where the live
    counts differ."""
    import numpy as np

    out = {k: float(np.abs(a[k].astype(np.float64)
                           - b[k].astype(np.float64)).max())
           for k in a if k.startswith("fields_")}
    for i in range(int(a["n_species"])):
        la, lb = a[f"sp{i}_w"] > 0, b[f"sp{i}_w"] > 0
        for c in CLI_CHANNELS:
            k = f"sp{i}_{c}"
            out[k] = (float(np.abs(np.sort(a[k][la]).astype(np.float64)
                                   - np.sort(b[k][lb]).astype(np.float64))
                            .max(initial=0.0))
                      if la.sum() == lb.sum() else math.inf)
    return out


def _rounding_units(a: dict) -> dict:
    """One ulp of the largest |value| of a checkpoint, in its own dtype: per
    field component, and per species and channel over the live particles
    (the keys of ``_state_diffs``)."""
    import numpy as np

    def ulp(x):
        return float(np.spacing(np.abs(x).max(initial=0).astype(x.dtype)))

    out = {k: ulp(a[k]) for k in a if k.startswith("fields_")}
    for i in range(int(a["n_species"])):
        live = a[f"sp{i}_w"] > 0
        for c in CLI_CHANNELS:
            out[f"sp{i}_{c}"] = ulp(a[f"sp{i}_{c}"][live])
    return out


def _resumed_within_spread(label: str, ck: dict, card: str) -> None:
    """Checkpoints A, C, D of uninterrupted runs and B of a resumed one: if
    A, C and D agree bit for bit, B must too; if not, B may differ from A
    by no more than CLI_SPREAD times the largest difference among A, C and
    D, per field and per particle channel (``_state_diffs``), that
    difference taken as at least one ulp of the channel's largest value
    (``_rounding_units``)."""
    pairs = {p: _state_diffs(ck[p[0]], ck[p[1]])
             for p in ("AC", "AD", "CD", "AB")}
    unit = _rounding_units(ck["A"])
    spread = {k: max([unit[k]] + [pairs[p][k] for p in ("AC", "AD", "CD")])
              for k in pairs["AB"]}
    same = _identical(ck["A"], ck["C"]) and _identical(ck["A"], ck["D"])
    fmt = {p: {k: f"{v:.3e}" for k, v in d.items()} for p, d in pairs.items()}
    ratio = {k: round(pairs["AB"][k] / v, 3) for k, v in spread.items() if v}
    print(f"cli: {label}: the uninterrupted runs "
          f"{'agree bit for bit' if same else 'differ'}; max |X - Y| per "
          f"field and per species channel (live particles sorted) {fmt}; "
          f"|A - B| over the uninterrupted runs' largest {ratio} (bar "
          f"{CLI_SPREAD:g}) [{card}]")
    if same:
        check(_identical(ck["A"], ck["B"]),
              f"cli: {label}: the resumed run differs from uninterrupted "
              "runs that agree bit for bit")
    else:
        worse = {k: (pairs["AB"][k], v) for k, v in spread.items()
                 if pairs["AB"][k] > CLI_SPREAD * v}
        check(not worse, f"cli: {label}: the resumed run differs from A by "
              f"more than {CLI_SPREAD:g} x the uninterrupted runs' spread: "
              f"{worse}")


def _cli_laser_plasma(tmp: Path, dev, save: bool, card: str,
                      run_ms: float) -> dict:
    """laser_plasma at its full size through the CLI: all 1,697 steps (A),
    850 steps then --resume to 1,697 (B), and twice more uninterrupted (C,
    D).  If A, C and D agree bit for bit, B must too; if not, B may differ
    from A by no more than CLI_SPREAD times the largest difference among
    A, C and D, per field and per particle channel (``_state_diffs``), and
    at least one ulp of its largest value (``_rounding_units``).
    Live counts and overflow equal in all four."""
    import numpy as np

    from minipic_torch.decks import standard

    deck = standard.make("laser_plasma").deck
    n = deck.total_steps
    base = ["--deck", "laser_plasma", "--save-every", CLI_SAVE_EVERY]
    base += ["--save-particles"] if save else ["--no-save"]
    ns = len(deck.species)
    runs, outs = {}, {k: tmp / f"laser_plasma_{k}" for k in "ABCD"}
    runs["A"] = _cli(base + ["--out", outs["A"]], "laser_plasma A", card, ns)
    runs["B850"] = _cli(base + ["--out", outs["B"], "--steps", CLI_SPLIT],
                        f"laser_plasma B to step {CLI_SPLIT}", card, ns)
    at_split = _checkpoint(outs["B"])
    runs["B"] = _cli(base + ["--out", outs["B"], "--resume"],
                     f"laser_plasma B resumed to {n}", card, ns)
    for k in "CD":
        runs[k] = _cli(base + ["--out", outs[k]], f"laser_plasma {k}", card,
                       ns)
    ck = {k: _checkpoint(outs[k]) for k in "ABCD"}
    check(all(int(c["step"]) == n for c in ck.values()),
          "cli: laser_plasma: final steps")
    check(int(at_split["step"]) == CLI_SPLIT, "cli: checkpoint at the split")
    live = {k: [int((c[f"sp{i}_w"] > 0).sum())
                for i in range(int(c["n_species"]))] for k, c in ck.items()}
    ovf = {k: runs[k]["overflow"] for k in "ACD"}
    ovf["B"] = runs["B850"]["overflow"] + runs["B"]["overflow"]
    _resumed_within_spread("laser_plasma", ck, card)
    print(f"cli: laser_plasma: live {live}, overflow {ovf}, bucket slots "
          f"{ck['A']['sp0_x'].shape[1]} / {ck['A']['sp1_x'].shape[1]} "
          f"[{card}]")
    check(live["A"] == live["B"] == live["C"] == live["D"],
          f"cli: laser_plasma: live counts {live}")
    check(ovf["A"] == ovf["B"] == ovf["C"] == ovf["D"],
          f"cli: laser_plasma: overflow {ovf}")
    hist = json.loads((outs["A"] / "history.json").read_text())
    tot = np.asarray(hist["field_energy"]) + np.asarray(
        hist["kinetic_energy"]).sum(1)
    check(len(tot) == n and bool(np.isfinite(tot).all())
          and tot.max() <= 1.01 * tot[0],
          f"cli: laser_plasma: history.json energies (highest "
          f"{tot.max() / tot[0]:.6f} x E0)")
    print(f"cli: laser_plasma: {n} steps at {runs['A']['ms_per_step']:.4f} / "
          f"{runs['C']['ms_per_step']:.4f} ms/step through the CLI (A / C; "
          f"history every step, {runs['A']['saves']} saves) against "
          + (f"{run_ms:.4f} ms/step through Simulation.run in this call"
             if run_ms else "Simulation.run not timed in this call")
          + f"; total energy {tot[0]:.6e} -> {tot[-1]:.6e} [{card}]")
    if save:
        _cli_restarts(outs["B"], dev, deck, at_split, card)
    return dict(runs=runs, final=outs["A"], deck=deck)


def _cli_restarts(folder: Path, dev, deck, at_split: dict,
                  card: str) -> None:
    """With a writer: the particle snapshot at the split restores its live
    particles (io.checkpoint.particles_from_snapshot), and the field
    snapshot there equals the checkpoint's fields (fields_from_snapshot)."""
    import numpy as np

    from minipic_torch.io import checkpoint, hdf5

    snap = hdf5.load_particles(CLI_SPLIT, str(folder))
    parts = checkpoint.particles_from_snapshot(CLI_SPLIT, str(folder), deck,
                                               device=dev)
    for spec, p in zip(deck.species, parts):
        w = p.w.cpu().numpy().ravel()
        got = np.sort(np.stack([getattr(p, c).cpu().numpy().ravel()[w > 0]
                                .astype(np.float64) for c in CLI_CHANNELS]),
                      axis=1)
        want = np.sort(np.stack([snap[spec.name][c] for c in CLI_CHANNELS]),
                       axis=1)
        check(got.shape == want.shape and np.array_equal(got, want),
              f"cli: particles_from_snapshot({CLI_SPLIT}) {spec.name}")
    fields = checkpoint.fields_from_snapshot(CLI_SPLIT, str(folder), deck,
                                             device=dev)
    for name, c in zip(("ex", "ey", "ez", "bx", "by", "bz"), fields):
        check(np.array_equal(c.cpu().numpy(), at_split[f"fields_{name}"]),
              f"cli: fields_from_snapshot({CLI_SPLIT}) {name}")
    print(f"cli: laser_plasma: the snapshots at step {CLI_SPLIT} restore the "
          f"checkpoint's fields bit for bit and each species' live particles "
          f"[{card}]")


def _cli_pulse(tmp: Path, dev, save: bool, plot: bool, card: str) -> dict:
    """reference_pulse at 450^2 for CLI_PULSE_STEPS steps at the reference's
    save cadence, three times through the CLI and three times through
    Simulation.run (keeping Bz at each save step), in the order CLI_PULSE_ORDER
    so that neither always runs first: each run's ms/step; the snapshots'
    Bz equal the kept Bz (with a writer), or the card's tile windows equal
    numpy's at the final state (without one); field energy conserved to
    1e-4; every run's final fields, and those of a CLI run resumed half
    way, bit for bit alike (fields alone, the card is deterministic); the
    pulse's speed fit over the saved lineouts (not a bar at this length);
    with matplotlib, plot all."""
    import numpy as np
    import torch

    from minipic_torch import cli
    from minipic_torch.decks import standard
    from minipic_torch.diag.analysis import fit_pulse_speed
    from minipic_torch.io import hdf5

    case = standard.make("reference_pulse")
    deck = case.deck
    mid = deck.ny // 2
    kept, cli_runs, run_ms, ckpts, finals = {}, [], [], [], []

    def saver(st, i):
        kept[i] = st.fields.bz.clone()

    for how in CLI_PULSE_ORDER:
        if how == "cli":
            out = tmp / f"reference_pulse_{len(cli_runs)}"
            args = ["--deck", "reference_pulse", "--steps", CLI_PULSE_STEPS,
                    "--save-every", CLI_PULSE_SAVE_EVERY, "--out", out]
            r = _cli(args + ([] if save else ["--no-save"]),
                     f"reference_pulse {len(cli_runs)}", card)
            check(sum(r["launches"].values()) == 0,
                  "cli: reference_pulse launched a particle kernel")
            cli_runs.append(dict(r, out=out))
            ckpts.append(_checkpoint(out))
            continue
        sim = case.simulation(device=dev)
        kept.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(CLI_PULSE_STEPS, save_every=CLI_PULSE_SAVE_EVERY, saver=saver)
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t0) * 1e3 / CLI_PULSE_STEPS)
        finals.append({f"fields_{n}": c.cpu().numpy() for n, c in zip(
            ("ex", "ey", "ez", "bx", "by", "bz"), sim.state.fields)})
    out = cli_runs[0]["out"]
    hist = json.loads((out / "history.json").read_text())
    fe = np.asarray(hist["field_energy"])
    drift = float(np.abs(fe - fe[0]).max() / fe[0])
    check(len(fe) == CLI_PULSE_STEPS and drift < 1e-4,
          f"cli: reference_pulse: field energy drift {drift:.3e}")
    steps = sorted(kept)
    if not save:
        _snapshot_buffers(sim.state, deck, "reference_pulse final state",
                          card)
    kept = {i: bz.cpu().numpy() for i, bz in kept.items()}
    # Fields alone, the card's steps are deterministic: every run above and
    # a CLI run stopped half way and resumed end bit for bit alike.
    half = tmp / "reference_pulse_resumed"
    args_half = ["--deck", "reference_pulse", "--save-every",
                 CLI_PULSE_SAVE_EVERY, "--no-save", "--out", half]
    _cli(args_half + ["--steps", CLI_PULSE_STEPS // 2],
         "reference_pulse to half way", card)
    _cli(args_half + ["--steps", CLI_PULSE_STEPS, "--resume"],
         "reference_pulse resumed", card)
    ckpts.append(_checkpoint(half))
    check(all(_identical(c, ckpts[0]) for c in ckpts),
          "cli: reference_pulse: the CLI runs' checkpoints differ")
    for k, f in enumerate(finals):
        for name in ("ex", "ey", "ez", "bx", "by", "bz"):
            check(np.array_equal(f[f"fields_{name}"],
                                 ckpts[0][f"fields_{name}"]),
                  f"cli: reference_pulse: Simulation.run {k}'s final {name} "
                  "differs from the CLI's")
    if save:
        check(hdf5.available_steps(str(out)) == steps,
              "cli: reference_pulse: saved steps")
        kw = dict(nx_global=deck.nx, ny_global=deck.ny, guard=deck.guard,
                  interior_nx=deck.tile_nx, interior_ny=deck.tile_ny)
        for i in steps:
            bz = hdf5.load_field(i, str(out), "Bz", **kw)
            check(np.array_equal(bz, kept[i].astype(np.float64)),
                  f"cli: reference_pulse: snapshot Bz at step {i}")
        what = (f"{len(steps)} snapshots' reassembled Bz equal to the "
                "in-memory field at each step")
    else:
        what = ("no snapshot written (no writer); the card's tile windows "
                "equal numpy's at the final state")
    lines = np.stack([kept[i][mid].astype(np.float64) for i in steps[1:]])
    speed = fit_pulse_speed(np.asarray(steps[1:]) * deck.dt, lines, deck.dx)
    cli_ms = [r["ms_per_step"] for r in cli_runs]
    r = cli_runs[0]
    print(f"cli: reference_pulse {deck.nx}^2: {CLI_PULSE_STEPS} steps, in "
          f"the order {' '.join(CLI_PULSE_ORDER)}: "
          f"{' / '.join(f'{v:.4f}' for v in cli_ms)} ms/step through the "
          f"CLI ({r['saves']} saves, {r['ms_per_save']:.3f} ms a save, "
          f"writer {r['writer']}; mean {sum(cli_ms) / len(cli_ms):.4f}), "
          f"{' / '.join(f'{v:.4f}' for v in run_ms)} through Simulation.run "
          f"(mean {sum(run_ms) / len(run_ms):.4f}); field energy drift "
          f"{drift:.3e} (bar 1e-4); {what}; every run's final fields and a "
          f"CLI run's resumed at step {CLI_PULSE_STEPS // 2} bit for bit "
          f"alike; fit_pulse_speed over {len(lines)} lineouts {speed:.6f} c "
          f"(not a bar at this length) [{card}]")
    if save and plot:
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["plot", "all", "--folder", str(out),
                           "--max-frames", "20"])
        made = buf.getvalue().split()
        check(rc == 0 and len(made) == 4 and all(
            os.path.getsize(p) > 0 for p in made), f"cli: plot all: {made}")
        print(f"cli: plot all wrote {[os.path.basename(p) for p in made]}")
    else:
        print("cli: plot all not run: "
              + ("matplotlib is not installed" if not plot else
                 "no snapshots to plot"))
    return dict(cli_ms=cli_ms, run_ms=run_ms, drift=drift, speed=speed)


def _cli_diag_device(state, deck, card: str) -> None:
    """diag/device.py on the card at a state against the same calls on a
    CPU copy: counts (unit weights) exactly, and with the weights (the
    field, for the spectrum) in float64 to 1e-5 of the largest value.  In
    float32 the weighted sums differ by their order of addition, ~1e-7 x
    sqrt(particles in a bin): printed, not held to a bar."""
    from minipic_torch.core.state import ParticleState
    from minipic_torch.diag import device as ddev

    rtol = 1e-5
    calls = {
        "phase_space_hist": lambda p, spec: ddev.phase_space_hist(
            p, "x", "px")[0],
        "energy_spectrum": lambda p, spec: ddev.energy_spectrum(
            p, spec.mass)[0],
        "charge_density": lambda p, spec: ddev.charge_density(
            p, spec.charge, deck.ny, deck.nx),
        "current_moments": lambda p, spec: ddev.current_moments(
            p, spec.charge),
    }
    bars = {"counts": 0.0, "f64 weights": rtol, "f32 weights": None}

    def rel(a, b):
        a, b = a.cpu().double(), b.double()
        return float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)

    worst = {}
    for spec, p in zip(deck.species, state.species):
        variants = {"counts": p._replace(w=(p.w > 0).to(p.w.dtype)),
                    "f64 weights": p._replace(w=p.w.double()),
                    "f32 weights": p}
        for v, q in variants.items():
            qc = ParticleState(*(a.cpu() for a in q))
            for name, fn in calls.items():
                if v == "counts" and name == "current_moments":
                    continue
                err = rel(fn(q, spec), fn(qc, spec))
                key = f"{name} ({v})"
                worst[key] = max(worst.get(key, 0.0), err)
                check(bars[v] is None or err <= bars[v],
                      f"cli: diag/device {key} {spec.name} on the card vs "
                      f"the CPU: {err:.3e} of its largest value")
    ey = state.fields.ey
    for v, f in (("f64", ey.double()), ("f32", ey)):
        worst[f"field_spectrum_2d ({v})"] = rel(
            ddev.field_spectrum_2d(f), ddev.field_spectrum_2d(f.cpu()))
    check(worst["field_spectrum_2d (f64)"] <= rtol, "cli: field_spectrum_2d")
    print(f"cli: diag/device on the card at laser_plasma's final state "
          f"against the CPU, largest difference over the largest value "
          f"(counts bar 0, f64 bar {rtol:g}, f32 not barred): "
          f"{ {k: f'{v:.2e}' for k, v in worst.items()} } [{card}]")


def phase_cli(dev, card: str, lp_run_ms=None) -> dict:
    """The command line on the card (``minipic_torch.cli.main``, in this
    process): laser_plasma in full with a resume, reference_pulse at 450^2
    with its save cadence, and diag/device.py on laser_plasma's final
    state.  Which of h5py, matplotlib and the native writer the machine
    has is probed first: with neither writer the runs take --no-save and
    the card's part of a save is held to numpy's instead.  Returns the
    launches per kernel of each laser_plasma run."""
    import contextlib
    import importlib.util
    import shutil
    import tempfile

    from minipic_torch.io import checkpoint, hdf5, native

    have = {"h5py": hdf5.available(),
            "matplotlib": importlib.util.find_spec("matplotlib") is not None,
            "native writer": native.available()}
    t_phase = time.perf_counter()
    print(f"cli: host libraries: {have} [{card}]")
    save = have["h5py"] or have["native writer"]
    if not save:
        print("cli: no HDF5 file is written on the card: neither h5py nor "
              "the native writer (g++ and a libhdf5 runtime) is there, so "
              "the runs take --no-save")
    CLI_DIR.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=CLI_DIR))
    try:
        lp = _cli_laser_plasma(tmp, dev, save, card, lp_run_ms)
        state = checkpoint.load_checkpoint(str(lp["final"] / "checkpoint.npz"),
                                           lp["deck"], device=dev)
        _snapshot_buffers(state, lp["deck"], "laser_plasma final state",
                          card)
        _cli_diag_device(state, lp["deck"], card)
        del state
        _cli_pulse(tmp, dev, save, have["matplotlib"], card)
        _cli_mesh(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        with contextlib.suppress(OSError):
            CLI_DIR.rmdir()
    print(f"cli: the phase took {time.perf_counter() - t_phase:.1f} s")
    return {k: r["launches"] for k, r in lp["runs"].items()}


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
    diag = phase_diag(dev, card)
    phase_open_kernel(dev)
    for dtype in (None, torch.float64):
        phase_rebin_kernels(dev, dtype)
        phase_rebin_kernels_b6_b8(dev, dtype)
    phase_small_step(dev)
    b6 = phase_decks(dev)
    phase_open_twins(dev)
    phase_sharded_kernels(dev)
    phase_mesh_twins(dev, card)
    b6_launches = phase_physics(dev, card)
    torch.cuda.empty_cache()
    b6_f64 = phase_f64_physics(dev, card)
    torch.cuda.empty_cache()
    lp_advance, lp_rebin, lp_launches, lp_ms = phase_open_physics(dev, card)
    torch.cuda.empty_cache()
    phase_sort(dev, card)
    torch.cuda.empty_cache()
    sharded, lb_launches = phase_load_balance(dev, card)
    torch.cuda.empty_cache()
    numbers, jobs = phase_main(dev, card)
    numbers["advance"]["open"] = lp_advance
    torch.cuda.empty_cache()
    numbers64, jobs64 = phase_main(dev, card, "f64")
    torch.cuda.empty_cache()
    # The command line before the profile (it slows what runs after it).
    cli_launches = phase_cli(dev, card, lp_ms)
    # Device times last, in one profile (device_times).  First the launch
    # floor: the smallest kernel PyTorch launches, a one-element zero_(), by
    # the name of its fill kernel (or a memset); it runs before anything
    # else fills in the profile.
    decks = list(b6)
    one = torch.ones(1, device=dev)
    floor_job = (one.zero_, 20, ("FillFunctor", "fill", "Memset"))
    lp_kernels = [(sp, k, v) for sp, route in lp_rebin.items()
                  for k, v in route.items()]
    floor_ms, *times = device_times(
        [floor_job] + [b6[d].pop("job") for d in decks] + jobs
        + [v.pop("job") for _, _, v in lp_kernels]
        + [b6_f64.pop("job")] + jobs64)
    # The f64 path's: append_incoming on the f64 energy deck's final
    # state, the two copy kernels of the f64 headline.
    b6_f64["ms"], *copy64 = times[-1 - len(jobs64):]
    times = times[:-1 - len(jobs64)]
    for name, ms in zip(("append", "append_runs"), copy64):
        print(f"device: {name} at the f64 main path's shape: kernel "
              f"{ms:.4f} ms on the device (profiler), "
              f"{numbers64[name]['ms']:.4f} ms by CUDA events [{card}]")
        numbers64[name]["ms"] = ms
    print(f"device: append_incoming on the f64 energy deck's final state "
          f"({b6_f64['shape']}): kernel {b6_f64['ms']:.4f} ms on the device "
          f"(profiler), {b6_f64['wrapper_ms']:.4f} ms a call through the "
          f"wrapper, plain {b6_f64['plain_ms']:.3f} ms, bound "
          f"{b6_f64['bound_ms']:.4f} ms [{card}]")
    numbers64["append_incoming"] = {
        k: v for k, v in b6_f64.items()
        if k not in ("shape", "wrapper_ms", "route")}
    lp_times = times[-len(lp_kernels):]
    times = times[:-len(lp_kernels)]
    for d, ms in zip(decks, times):
        v = b6[d]
        v["ms"] = ms
        print(f"device: append_incoming on {d}'s final state ({v['shape']}): "
              f"kernel {ms:.4f} ms on the device (profiler), launch floor "
              f"(a one-element zero_()) {floor_ms:.4f} ms, "
              f"{v['wrapper_ms']:.4f} ms a call through the wrapper (CUDA "
              f"events), plain {v['plain_ms']:.3f} ms, bound "
              f"{v['bound_ms']:.4f} ms [{card}]")
    for name, ms in zip(("append", "append_runs"), times[len(decks):]):
        print(f"device: {name} at the main path's shape: kernel {ms:.4f} ms "
              f"on the device (profiler), {numbers[name]['ms']:.4f} ms by "
              f"CUDA events [{card}]")
        numbers[name]["ms"] = ms
    # append_incoming's launches are those of the two_stream deck's run
    # through Simulation.run; its times, at that deck's shape.
    numbers["append_incoming"] = {
        k: v for k, v in b6["two_stream"].items()
        if k not in ("shape", "wrapper_ms", "route")}
    numbers["append_incoming"]["launches"] = b6_launches
    # laser_plasma's: launches in its run, numbers per species.
    for (sp, name, v), ms in zip(lp_kernels, lp_times):
        v["ms"] = ms
        numbers[name].setdefault("laser_plasma", dict(
            launches=lp_launches[name]))[sp] = v
        print(f"device: {name} on laser_plasma's final state, {sp} "
              f"({v['route']} route, {v['shape']}): kernel {ms:.4f} ms on "
              f"the device (profiler), plain {v['plain_ms']:.3f} ms, bound "
              f"{v['bound_ms']:.4f} ms ({v['bound_by']}), equal to its "
              f"plain version (max abs err {v['max_abs_err']:.1e}) [{card}]")
    for run, launches in cli_launches.items():
        for name in KERNELS:
            numbers[name].setdefault("cli", {})[
                f"laser_plasma {run}"] = launches[name]
    # The multi-device slice: B1-B3 at load_balance_stress's shard, and
    # every kernel's launches in each load_balance run.
    for name in KERNELS:
        if name in sharded:
            numbers[name]["sharded"] = sharded[name]
        numbers[name]["load_balance"] = {
            run: launches[name] for run, launches in lb_launches.items()}
        # The f64 path: the f64 headline's numbers (append_incoming's at
        # the f64 energy deck), with each kernel's launches there.
        numbers[name]["f64"] = numbers64[name]
    print(card)
    for name, v in diag.items():
        v["launches"] = numbers.pop(f"{name}_launches")
        v["f64"]["launches"] = numbers64.pop(f"{name}_launches")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1], **numbers[name])
        for name in KERNELS] + [
        dict(name=name, route="cuda", source=DIAG_SOURCE, replaces=None, **v)
        for name, v in diag.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
