"""What bounds the advance kernel: csrc/advance.cu timed against a copy of it
whose shared-memory ``atomicAdd`` calls are no-ops.

    python3 -m minipic_torch.probe_atomics [--steps N] [--reps R]

on a CUDA card loads ``headline_deck()``, steps it N times (J from the
first steps makes the fields non-zero), cuts the field windows of that
state as the step does, and times each kernel on it with CUDA events, in
the int8 and the f32 deposit mode, alternating real and no-op R times.
With the atomics gone the compiler drops the deposit arithmetic too, so
the gap between the two is the deposit's cost.  The no-op copy's J is
wrong by design; only its time is read.  The copy is written and built
under ``minipic_torch/_build/``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from .fields.halo import pad_fields_periodic
from .fields.tiles import extract_field_tiles
from .headline import headline_deck
from .ops._build import BUILD_DIR, CSRC
from .ops.advance import AdvanceKernel, live_watermark

_INCLUDE = "#include <cuda_runtime.h>\n"
_NO_ATOMICS = "#define atomicAdd(addr, val) ((void)0)\n"


def no_atomics_source() -> str:
    """advance.cu with every atomicAdd after its include made a no-op."""
    src = (CSRC / "advance.cu").read_text()
    if src.count(_INCLUDE) != 1:
        raise RuntimeError("advance.cu: expected one cuda_runtime include")
    return src.replace(_INCLUDE, _INCLUDE + _NO_ATOMICS)


def _ms(fn) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def main(argv=None) -> int:
    from .simulation import Simulation

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    variant = BUILD_DIR / "probe" / "advance_noatomics.cu"
    variant.parent.mkdir(parents=True, exist_ok=True)
    variant.write_text(no_atomics_source())
    kernels = {"real": AdvanceKernel(), "no-atomics": AdvanceKernel(variant)}

    dev = torch.device("cuda", 0)
    deck = headline_deck()
    sim = Simulation(deck, seed=0, device=dev)
    sim.step(args.steps)
    tl, g = deck.tiling, deck.guard
    ftiles = extract_field_tiles(
        pad_fields_periodic(sim.state.fields, g), tl.tile_rows, tl.tile_cols,
        tl.tile_ny, tl.tile_nx, g)
    p = sim.state.species[0]
    counts = live_watermark(p.w)
    spec = deck.species[0]
    kw = dict(qm=spec.charge / spec.mass, q=spec.charge,
              order=spec.shape_order, tile_ny=tl.tile_ny, tile_nx=tl.tile_nx,
              tile_cols=tl.tile_cols, g=g, dt=deck.dt, dx=deck.dx, dy=deck.dy,
              grid=(deck.nx, deck.ny))

    times = {}
    for mode in ("int8", "f32"):
        for k in kernels.values():  # first launch loads the module
            k(p, ftiles, counts, mode=mode, **kw)
        for _ in range(args.reps):
            for name, k in kernels.items():
                times.setdefault((mode, name), []).append(
                    _ms(lambda: k(p, ftiles, counts, mode=mode, **kw)))
    print(f"probe: headline state after {args.steps} steps, "
          f"{int((p.w > 0).sum())} particles in {tuple(p.x.shape)} slots "
          f"[{card}]")
    for (mode, name), ts in times.items():
        print(f"probe: {mode:4s} {name:10s} "
              + " / ".join(f"{t:.3f}" for t in ts) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
