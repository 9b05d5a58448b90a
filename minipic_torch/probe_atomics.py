"""What bounds the advance kernel: csrc/advance.cu timed against copies of it
built without a part of its deposit, or with another form of it.

    python3 -m minipic_torch.probe_atomics [--steps N] [--reps R]
        [--variants NAME ...] [--modes MODE ...] [--layouts LAYOUT ...]

on a CUDA card loads ``headline_deck()``, steps it N times (J from the
first steps makes the fields non-zero), cuts the field windows of that
state as the step does, and times each kernel on it with CUDA events, in
each deposit mode of `--modes` (int8, f32, and f64 on that state cast to
double; default all three) and each layout of `--layouts` (lattice: the
buckets as the step leaves them; shuffled: each bucket's live slots in a
random order), alternating the real kernel and the copies R times.  The
copies (``VARIANTS``; by default ``no-deposit``):

* ``no-deposit`` defines ``MINIPIC_NO_DEPOSIT``, which the source reads: it
  skips the whole deposit (the s1 shapes, the operand staging, the
  tensor-core products, the warp reductions and every add), so the gap
  to the real kernel is the deposit's cost;
* ``no-staging``, ``no-jz-products``, ``no-int8-products`` drop one part of
  the int8 deposit (the staging stores, the bf16 jz products, the int8
  jx/jy products); ``checked-gather`` takes the bounds-checked gather for
  every particle;
* other forms of the f32 and f64 deposit into private J windows (the
  headline's): ``staged`` takes the staged sums for every slab (the
  kernel: past kMaxPasses = 3 lanes a base), ``passes`` the passes by
  rank for every slab, and ``passes-nostage`` does that without the
  staging area in shared memory (only that copy may drop it: it never
  stages); ``stage-only`` stages every slab's terms and adds none of
  them (the staging's own cost); ``trees`` sums each base by shuffle
  trees where a slab holds at most kMaxGroups bases and adds lane by lane
  with shared atomics past them, into the warp's own windows (what shared
  sets do); ``all-groups`` takes the trees for every slab; ``contiguous``
  walks each warp over one contiguous eighth of its bucket instead of
  every eighth slab, so that a warp's consecutive slabs share a base;
  ``carry`` does that with the trees and keeps a warp's tree sums in
  registers while the base stays, adding them to its windows only when
  the base changes.

Each edit must match the source exactly once.  A part-removing copy's J
is wrong by design; only its time is read.  The copies are written and
built under ``minipic_torch/_build/``.  Also printed: each kernel's
resident blocks per SM (the occupancy calculator's answer for its
registers and shared memory).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from .fields.halo import pad_fields_periodic
from .fields.tiles import extract_field_tiles
from .headline import headline_deck
from .ops._build import BUILD_DIR, CSRC, build
from .ops.advance import AdvanceKernel, live_watermark

_INCLUDE = "#include <cuda_runtime.h>\n"
_NO_DEPOSIT = "#define MINIPIC_NO_DEPOSIT 1\n"
# The contiguous walk: warp w takes slabs [w * per, (w + 1) * per).
_CONTIGUOUS = (
    "  const int s_first = warp * 32, s_step = kThreads, s_end = count32;\n",
    "  const int s_per = ((count32 + 31) / 32 + kWarps - 1) / kWarps * 32;\n"
    "  const int s_first = warp * s_per, s_step = 32,\n"
    "            s_end = min(count32, s_first + s_per);\n")
# Private sets through the shuffle trees (at most kMaxGroups bases) and
# lane-by-lane atomics into the warp's own windows, as shared sets take.
_TREES = ("  if constexpr (OWN) {\n    const int rank",
          "  if constexpr (false) {\n    const int rank")
# Every slab through the staged sums.
_STAGED = ("constexpr int kMaxPasses = 3;", "constexpr int kMaxPasses = 0;")
# Every slab through the passes by rank (any number of lanes a base).
_PASSES = ("constexpr int kMaxPasses = 3;", "constexpr int kMaxPasses = 32;")
# The register carry: a warp's tree sums of one base stay in registers
# (carry, carry_key) until a group of another base comes; then, and at the
# end of the walk, its even lanes add them to their 16 cells.
_CARRY = (
    ("// f32 and f64 modes: adds the jx, jy and jz terms v[3][16] (cell (row0 +\n",
     "template <typename R>\n"
     "__device__ __forceinline__ void flush_carry(R* const win[3], R carry[3],\n"
     "                                            unsigned key, int lane,\n"
     "                                            int nyg, int nxg) {\n"
     "  if (key == kFull) return;\n"
     "  const int idx = (lane >> 1) & 15;\n"
     "  const int r = (int)(key >> 16) - 4 + (idx >> 2);\n"
     "  const int c = (int)(key & 0xffffu) - 4 + (idx & 3);\n"
     "  if ((lane & 1) == 0 && r >= 0 && r < nyg && c >= 0 && c < nxg)\n"
     "    for (int n = 0; n < 3; ++n)\n"
     "      win[n][r * nxg + c] = win[n][r * nxg + c] + carry[n];\n"
     "  for (int n = 0; n < 3; ++n) carry[n] = R(0);\n"
     "}\n\n"
     "// f32 and f64 modes: adds the jx, jy and jz terms v[3][16] (cell (row0 +\n"),
    ("                                             R* stage, bool dep,\n",
     "                                             R* stage, bool dep,\n"
     "                                             R carry[3],\n"
     "                                             unsigned& carry_key,\n"),
    ("        const R s = reduce16(t, lane);\n"
     "        if (add) atomicAdd(&win[n][r * nxg + c], s);\n"
     "      }\n",
     "        const R s = reduce16(t, lane);\n"
     "        if (n == 0 && lkey != carry_key) {\n"
     "          flush_carry(win, carry, carry_key, lane, nyg, nxg);\n"
     "          carry_key = lkey;\n"
     "        }\n"
     "        carry[n] = carry[n] + s;\n"
     "      }\n"),
    ("  R* const wins[3] = {set, set + nwin, set + 2 * nwin};\n",
     "  R* const wins[3] = {set, set + nwin, set + 2 * nwin};\n"
     "  R carry[3] = {R(0), R(0), R(0)};\n"
     "  unsigned carry_key = kFull;\n"),
    ("      warp_deposit<!SHARED>(wins, v, stage, live, row0, col0, lane, nyg,\n"
     "                            nxg);\n",
     "      warp_deposit<!SHARED>(wins, v, stage, live, carry, carry_key, row0,\n"
     "                            col0, lane, nyg, nxg);\n"),
    ("  for (int s = count32 + threadIdx.x; s < P.capacity; s += blockDim.x) {\n",
     "  flush_carry(wins, carry, carry_key, lane, nyg, nxg);\n"
     "  for (int s = count32 + threadIdx.x; s < P.capacity; s += blockDim.x) {\n"),
)
# name -> the edits of csrc/advance.cu: (text, its replacement) each
VARIANTS = {
    "no-deposit": ((_INCLUDE, _INCLUDE + _NO_DEPOSIT),),
    "no-staging": ((
        "      st.put_rows(ops, last_live, last_prod, last_row0, nyg, true);\n"
        "      st.put_cols(ops, last_live, last_prod, last_col0, nxg, true);\n"
        "      st.put_rows(ops, live, prod, row0, nyg, false);\n"
        "      st.put_cols(ops, live, prod, col0, nxg, false);\n", ""),),
    "no-jz-products": (("      st.jz_products(lane, accz);\n", ""),),
    "no-int8-products": ((
        "      if (__any_sync(kFull, prod)) st.int8_products(lane, accx, accy);"
        "\n", ""),),
    "checked-gather": (("      if (min(iyi, iyh) + g >= 1 &&",
                        "      if (false && min(iyi, iyh) + g >= 1 &&"),),
    "contiguous": (_CONTIGUOUS,),
    "trees": (_TREES,),
    "all-groups": (_TREES, ("constexpr int kMaxGroups = 4;",
                            "constexpr int kMaxGroups = 32;")),
    "carry": (_CONTIGUOUS, _TREES) + _CARRY,
    "staged": (_STAGED,),
    "stage-only": (_STAGED, (
        "    for (unsigned todo = leaders; todo; todo &= todo - 1) {\n"
        "      const int first",
        "    for (unsigned todo = 0u; todo; todo &= todo - 1) {\n"
        "      const int first")),
    "passes": (_PASSES,),
    "passes-nostage": (_PASSES, (
        "(win_warps == 1 ? (size_t)kWarps * kTerms *",
        "(win_warps == 0 ? (size_t)kWarps * kTerms *")),
}


def variant_source(name: str) -> str:
    """advance.cu with the edits of VARIANTS[name], each made once."""
    src = (CSRC / "advance.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"advance.cu: an edit of {name} does not "
                               "match exactly once")
        src = src.replace(old, new)
    return src


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
    ap.add_argument("--modes", nargs="+", choices=("int8", "f32", "f64"),
                    default=["int8", "f32", "f64"])
    ap.add_argument("--layouts", nargs="+", choices=("lattice", "shuffled"),
                    default=["lattice"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kernels = {"real": AdvanceKernel()}
    paths = ["advance.cu"]
    for name in args.variants:
        path = BUILD_DIR / "probe" / f"advance_{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(variant_source(name))
        kernels[name] = AdvanceKernel(path)
        paths.append(path)
    with ThreadPoolExecutor(len(paths)) as pool:  # one nvcc each, at once
        list(pool.map(build, paths))

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
    del sim
    spec = deck.species[0]
    kw = dict(qm=spec.charge / spec.mass, q=spec.charge,
              order=spec.shape_order, tile_ny=tl.tile_ny, tile_nx=tl.tile_nx,
              origins=tile_origins(tl, dev), g=g, dt=deck.dt, dx=deck.dx,
              dy=deck.dy,
              grid=(deck.nx, deck.ny))

    times = {}
    for layout in args.layouts:
        if layout == "shuffled":
            p = shuffled(p, counts)
        for mode in args.modes:
            pm, fm = p, ftiles
            if mode == "f64":
                pm = type(p)(*(a.double() for a in p))
                fm = type(ftiles)(*(a.double() for a in ftiles))
            for k in kernels.values():  # first launch loads the module
                k(pm, fm, counts, mode=mode, **kw)
            for _ in range(args.reps):
                for name, k in kernels.items():
                    times.setdefault((layout, mode, name), []).append(
                        _ms(lambda: k(pm, fm, counts, mode=mode, **kw)))
            del pm, fm
    print(f"probe: headline state after {args.steps} steps, "
          f"{int((p.w > 0).sum())} particles in {tuple(p.x.shape)} slots "
          f"[{card}]")
    nyg, nxg = tl.tile_ny + 2 * g, tl.tile_nx + 2 * g
    for (layout, mode, name), ts in times.items():
        blocks = kernels[name].blocks_per_sm(spec.shape_order, mode, nyg, nxg)
        print(f"probe: {layout:8s} {mode:4s} {name:16s} "
              + " / ".join(f"{t:.3f}" for t in ts)
              + f" ms; {blocks} blocks of 256 threads per SM")
    return 0


def shuffled(p, counts, seed: int = 3):
    """`p` with each bucket's slots below its watermark `counts` in a
    random order (seeded on the card); the slots past it stay."""
    T, cap = p.x.shape
    gen = torch.Generator(device=p.x.device).manual_seed(seed)
    slot = torch.arange(cap, device=p.x.device)[None, :]
    keys = torch.where(slot < counts[:, None],
                       torch.rand((T, cap), generator=gen,
                                  device=p.x.device), 2.0 + slot / cap)
    perm = torch.argsort(keys, dim=1)
    return type(p)(*(torch.gather(a, 1, perm) for a in p))


if __name__ == "__main__":
    sys.exit(main())
