"""What bounds the advance kernel: csrc/advance.cu timed against copies of it
built without a part of its deposit.

    python3 -m minipic_torch.probe_atomics [--steps N] [--reps R]
        [--variants NAME ...]

on a CUDA card loads ``headline_deck()``, steps it N times (J from the
first steps makes the fields non-zero), cuts the field windows of that
state as the step does, and times each kernel on it with CUDA events, in
the int8 and the f32 deposit mode, alternating the real kernel and the
copies R times.  The copies (``VARIANTS``; by default ``no-deposit``):

* ``no-deposit`` defines ``MINIPIC_NO_DEPOSIT``, which the source reads: it
  skips the whole deposit (the s1 shapes, the operand staging, the
  tensor-core products, the warp reductions and every atomic), so the gap
  to the real kernel is the deposit's cost;
* ``no-staging``, ``no-jz-products``, ``no-int8-products`` drop one part of
  the int8 deposit (the staging stores, the bf16 jz products, the int8
  jx/jy products); ``checked-gather`` takes the bounds-checked gather for
  every particle.  Each edit must match the source exactly once.

A copy's J is wrong by design; only its time is read.  The copies are
written and built under ``minipic_torch/_build/``.  Also printed: each
kernel's resident blocks per SM (the occupancy calculator's answer for its
registers and shared memory).
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
_NO_DEPOSIT = "#define MINIPIC_NO_DEPOSIT 1\n"
# name -> (text of csrc/advance.cu, its replacement)
VARIANTS = {
    "no-deposit": (_INCLUDE, _INCLUDE + _NO_DEPOSIT),
    "no-staging": (
        "      st.put_rows(ops, last_live, last_prod, last_row0, nyg, true);\n"
        "      st.put_cols(ops, last_live, last_prod, last_col0, nxg, true);\n"
        "      st.put_rows(ops, live, prod, row0, nyg, false);\n"
        "      st.put_cols(ops, live, prod, col0, nxg, false);\n", ""),
    "no-jz-products": ("      st.jz_products(lane, accz);\n", ""),
    "no-int8-products": (
        "      if (__any_sync(kFull, prod)) st.int8_products(lane, accx, accy);"
        "\n", ""),
    "checked-gather": ("      if (min(iyi, iyh) + g >= 1 &&",
                       "      if (false && min(iyi, iyh) + g >= 1 &&"),
}


def variant_source(name: str) -> str:
    """advance.cu with the edit of VARIANTS[name]."""
    old, new = VARIANTS[name]
    src = (CSRC / "advance.cu").read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"advance.cu: the {name} edit does not match "
                           "exactly once")
    return src.replace(old, new)


def no_deposit_source() -> str:
    """advance.cu with MINIPIC_NO_DEPOSIT defined after its include."""
    return variant_source("no-deposit")


def _ms(fn) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def main(argv=None) -> int:
    from .simulation import Simulation, tile_origins

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--variants", nargs="+", choices=sorted(VARIANTS),
                    default=["no-deposit"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kernels = {"real": AdvanceKernel()}
    for name in args.variants:
        path = BUILD_DIR / "probe" / f"advance_{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(variant_source(name))
        kernels[name] = AdvanceKernel(path)

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
              origins=tile_origins(tl, dev), g=g, dt=deck.dt, dx=deck.dx,
              dy=deck.dy,
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
    nyg, nxg = tl.tile_ny + 2 * g, tl.tile_nx + 2 * g
    for (mode, name), ts in times.items():
        blocks = kernels[name].blocks_per_sm(spec.shape_order, mode, nyg, nxg)
        print(f"probe: {mode:4s} {name:16s} "
              + " / ".join(f"{t:.3f}" for t in ts)
              + f" ms; {blocks} blocks of 256 threads per SM")
    return 0


if __name__ == "__main__":
    sys.exit(main())
