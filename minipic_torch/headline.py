"""The headline configuration on the port, and a device-time profile of its
step.

``headline_deck()`` is bench.py:58-102's deck exactly (1e8 electrons on
512^2, 8x8 tiles, guard 4, TSC, int8 deposit, whole-bucket chunks,
headroom 1.1, ``rebin_mode`` at its default "auto": the deal-route
re-bin).  ``headline_deck(rebin_mode="sort")`` drives the sort re-bin
instead.

    python3 -m minipic_torch.headline [--steps N] [--trace PATH]
        [--deck NAME [--layout single|sharded|balanced]]

on a CUDA card loads that deck (or, with ``--deck``, a deck of
``decks.standard`` as its users start it: its initial fields and its
seeder, e.g. ``--deck laser_plasma``, through ``--layout``: one device, or
the block-sharded or striped simulation over the deck's mesh), warms up, and
traces N steps that
only advance plus one forced re-bin step with ``torch.profiler`` (a deck
with no species only advances its fields).  It prints the ms a step and
the share of the traced wall time in which the device ran a kernel, the
launches a step, the span
of the device timeline each profiler range of the step covers
(``minipic.advance``, ``.fields``, ``.rebin``, ``.diag``, and the
multi-device simulations' collectives, ``.parallel``), and the kernels that
take the most device time.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

from .core.config import Deck, SpeciesSpec

RANGES = ("minipic.advance", "minipic.fields", "minipic.rebin",
          "minipic.diag", "minipic.parallel")


def headline_deck(grid: int = 512, order: int = 2,
                  rebin_mode: str = "auto") -> Deck:
    """bench.py's deck with ppc = round(1e8 / 512^2) = 381; `grid` cuts the
    box (not the widths) for smaller runs."""
    ppc = max(1, round(1e8 / 512 ** 2))
    return Deck(
        box_x=grid / 10.0, box_y=grid / 10.0, nx=grid, ny=grid, tile_nx=8,
        tile_ny=8, guard=4,
        species=(SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.05,
                             shape_order=order),),
        precision="f32", rebin_interval=8, capacity_headroom=1.1, kchunk=0,
        deposit="int8", rebin_mode=rebin_mode)


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _busy_us(events) -> float:
    """Length of the union of the device kernels' time intervals (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if _is_device(e) and e.name not in RANGES)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def _force_rebin(sim) -> None:
    """Make the next step's drift predicate fire."""
    if hasattr(sim, "shard_state"):  # a multi-device simulation: no assembly
        st = sim.shard_state
        sim.shard_state = st._replace(
            drift=torch.full_like(st.drift, float("inf")))
        return
    sim.state = sim.state._replace(
        drift=torch.full_like(sim.state.drift, float("inf")))


def main(argv=None) -> int:
    from torch.profiler import ProfilerActivity, profile

    from .simulation import Simulation

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default="", help="write a Chrome trace here")
    ap.add_argument("--deck", default="", help="profile this deck of "
                    "decks.standard instead")
    ap.add_argument("--layout", default="single",
                    choices=("single", "sharded", "balanced"),
                    help="one device, or the deck's mesh block-sharded or "
                    "striped (with --deck)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    if args.deck:
        from .decks import standard

        sim = standard.make(args.deck).simulation(seed=0, device=dev,
                                                  layout=args.layout)
    else:
        sim = Simulation(headline_deck(), seed=0, device=dev)
    # Warm-up, a re-bin included: first launches load their modules.
    sim.step(2)
    _force_rebin(sim)
    sim.step(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(args.steps)
        _force_rebin(sim)
        sim.step(1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    per_step = wall_us / 1e3 / (args.steps + 1)
    print(f"profile: {args.steps} advance-only steps + 1 re-bin step, "
          f"wall {wall_us / 1e3:.3f} ms ({per_step:.3f} ms a step), device "
          f"busy {100 * _busy_us(events) / wall_us:.1f}% [{card}]")
    n_kernels = sum(1 for e in events
                    if _is_device(e) and e.name not in RANGES)
    print(f"profile: {n_kernels} kernel launches, "
          f"{n_kernels / (args.steps + 1):.1f} a step")
    for r in RANGES:
        spans = [e.time_range.elapsed_us() for e in events
                 if _is_device(e) and e.name == r]
        host = [e.time_range.elapsed_us() for e in events
                if not _is_device(e) and e.name == r]
        print(f"profile: range {r}: {sum(spans) / 1e3:.3f} ms of device "
              f"timeline over {len(spans)} spans, {sum(host) / 1e3:.3f} ms "
              "on the host")
    kernels = sorted((e for e in prof.key_averages()
                      if _is_device(e) and e.key not in RANGES),
                     key=lambda e: -e.self_device_time_total)
    for e in kernels[:15]:
        print(f"profile: kernel {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:4d}  {e.key[:90]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
