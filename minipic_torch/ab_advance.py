"""The advance (B1) and the steps around it, for an A/B of two trees.

    python3 path/to/ab_advance.py LABEL [--cells CELL ...]

run from the root of a checkout times THAT checkout's package (the working
directory comes first on the import path), so one script times a parent
tree and a change in turns (parent, change, change, parent, ...), each in a
process of its own.  Cells (default: all):

* ``f32``: ``headline_deck()`` (bench.py's deck, the int8 deposit), 60 steps
  from the seed-0 load with a host clock around each synchronized step;
  then the advance alone on the final state in its int8 and f32 modes;
* ``f64``: the same deck at precision "f64" (the advance's f64 mode), 60
  steps; then the f64 advance on the final state;
* ``laser_plasma``: its whole run through ``Simulation.run``; then the
  advance's open mode (f32, CIC, 20^2 windows) on the final state's
  electrons;
* ``load_balance_stress``: sharded on the (2, 4) mesh, all shards on the
  card, its 282 steps of ``run_step``; then the f32 advance at shard 5
  (mesh row 1, column 1) of the final state's electrons.

The advance is timed with CUDA events over REPS launches after one, in
lattice order (the buckets as the run leaves them) and with each bucket's
live slots shuffled.  Each cell prints one line, ``ab LABEL CELL: ...``:
ms/step (mean; the headline cells also the advance-only steps' median)
and the advance times.  Last, ``ab LABEL fingerprint``: a hash of the
advance's new positions and momenta in the f32 and f64 modes on inputs
made from a seed on the card, lattice and shuffled; a change to the
deposit alone leaves it as it was.  Build the kernels first
(``minipic_torch.ops._build.build``): a first launch that compiles lands in
the first step.
"""
import argparse
import hashlib
import statistics
import sys
import time

sys.path.insert(0, ".")
import torch  # noqa: E402

CELLS = ("f64", "f32", "laser_plasma", "load_balance_stress")
STEPS = 60
REPS = 5


def _ms(fn, reps: int = REPS) -> float:
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _shuffled(p, counts, seed: int = 3):
    """`p` with each bucket's live slots (below `counts`) in a random
    order."""
    T, cap = p.x.shape
    gen = torch.Generator(device=p.x.device).manual_seed(seed)
    slot = torch.arange(cap, device=p.x.device)[None, :]
    keys = torch.where(slot < counts[:, None],
                       torch.rand((T, cap), generator=gen,
                                  device=p.x.device), 2.0 + slot / cap)
    perm = torch.argsort(keys, dim=1)
    return type(p)(*(torch.gather(a, 1, perm) for a in p))


def _advance_times(p, ft, kw, modes) -> str:
    """The advance in each mode on `p`, lattice and shuffled."""
    from minipic_torch.ops.advance import advance_kernel, live_watermark

    counts = live_watermark(p.w)
    ps = _shuffled(p, counts)
    out = []
    for mode in modes:
        k = dict(kw, mode=mode)
        lat = _ms(lambda: advance_kernel(p, ft, counts, **k))
        shf = _ms(lambda: advance_kernel(ps, ft, counts, **k))
        out.append(f"advance {mode} {lat:.3f} ms, shuffled {shf:.3f} ms")
    return "; ".join(out)


def _steps(sim, n: int):
    """n synchronized steps: (all step times, advance-only step times) in
    ms."""
    times, adv = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        times.append(ms)
        if float(sim.state.drift) != 0.0:
            adv.append(ms)
    return times, adv


def _headline(dev, precision: str) -> str:
    import dataclasses

    from minipic_torch.fields.halo import pad_fields_periodic
    from minipic_torch.fields.tiles import extract_field_tiles
    from minipic_torch.headline import headline_deck
    from minipic_torch.simulation import Simulation, tile_origins

    deck = dataclasses.replace(headline_deck(), precision=precision)
    sim = Simulation(deck, seed=0, device=dev)
    times, adv = _steps(sim, STEPS)
    t, g = deck.tiling, deck.guard
    ft = extract_field_tiles(pad_fields_periodic(sim.state.fields, g),
                             t.tile_rows, t.tile_cols, t.tile_ny, t.tile_nx,
                             g)
    p = sim.state.species[0]
    del sim
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=t.tile_ny, tile_nx=t.tile_nx,
              origins=tile_origins(t, dev), g=g, dt=deck.dt, dx=deck.dx,
              dy=deck.dy, grid=(deck.nx, deck.ny))
    modes = ("f64",) if precision == "f64" else ("int8", "f32")
    return (f"ms/step {statistics.mean(times):.3f} mean, advance-only "
            f"median {statistics.median(adv):.3f} over {len(adv)}; "
            + _advance_times(p, ft, kw, modes) + " at the final state")


def _laser_plasma(dev) -> str:
    from minipic_torch.decks import standard
    from minipic_torch.fields.halo import pad_fields_periodic
    from minipic_torch.fields.tiles import extract_field_tiles
    from minipic_torch.simulation import tile_origins

    case = standard.make("laser_plasma")
    deck = case.deck
    sim = case.simulation(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(deck.total_steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / deck.total_steps
    t, g = deck.tiling, deck.guard
    ft = extract_field_tiles(pad_fields_periodic(sim.state.fields, g),
                             t.tile_rows, t.tile_cols, t.tile_ny, t.tile_nx,
                             g)
    spec = deck.species[0]
    kw = dict(qm=spec.charge / spec.mass, q=spec.charge,
              order=spec.shape_order, tile_ny=t.tile_ny, tile_nx=t.tile_nx,
              origins=tile_origins(t, dev), g=g, dt=deck.dt, dx=deck.dx,
              dy=deck.dy, grid=None)
    return (f"ms/step {ms:.3f} over {deck.total_steps} steps; "
            + _advance_times(sim.state.species[0], ft, kw, ("f32",))
            + " on the final state's electrons")


def _load_balance_stress(dev) -> str:
    from minipic_torch.core.state import FieldState
    from minipic_torch.decks import standard
    from minipic_torch.fields.tiles import extract_field_tiles
    from minipic_torch.parallel.halo import exchange_halo
    from minipic_torch.parallel.mesh import local_tile_grid
    from minipic_torch.simulation import tile_origins

    case = standard.make("load_balance_stress")
    deck = case.deck
    sim = case.simulation(seed=0, device=dev, layout="sharded")
    steps = deck.total_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        sim.run_step(i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    mesh, st, s = sim.mesh, sim.shard_state, 5
    r, c = mesh.coords(s)
    ltr, ltc = local_tile_grid(deck, mesh)
    t, g = deck.tiling, deck.guard
    padded = exchange_halo([torch.stack(tuple(f)) for f in st.fields], g,
                           mesh)[s]
    ft = extract_field_tiles(FieldState(*padded.unbind(0)), ltr, ltc,
                             t.tile_ny, t.tile_nx, g)
    p = st.species[s][0]
    del sim, st
    spec = deck.species[0]
    kw = dict(qm=spec.charge / spec.mass, q=spec.charge,
              order=spec.shape_order, tile_ny=t.tile_ny, tile_nx=t.tile_nx,
              origins=tile_origins(t, dev, r * ltr, c * ltc, ltr, ltc), g=g,
              dt=deck.dt, dx=deck.dx, dy=deck.dy, grid=(deck.nx, deck.ny))
    return (f"ms/step {ms:.3f} over {steps} steps (sharded); "
            + _advance_times(p, ft, kw, ("f32",)) + f" at shard {s}")


def _fingerprint(dev) -> str:
    """sha256 of the advance's new positions and momenta in the f32 and
    f64 modes, lattice and shuffled, on 16 tiles of 1024 slots made from a
    seed: 700 live a bucket over 8x8-cell tiles of a 32^2 box."""
    from minipic_torch.core.geometry import Tiling
    from minipic_torch.core.state import FieldState, ParticleState
    from minipic_torch.ops.advance import advance_kernel, live_watermark
    from minipic_torch.simulation import tile_origins

    gen = torch.Generator(device=dev).manual_seed(0)
    T, cap = 16, 1024
    rnd = lambda *s: torch.rand(s, generator=gen, device=dev)  # noqa: E731
    slot = torch.arange(cap, device=dev)[None, :]
    t = torch.arange(T, device=dev)[:, None]
    cell = slot // 11
    x = (t % 4) * 8 + cell % 8 + rnd(T, cap)
    y = (t // 4) * 8 + (cell // 8) % 8 + rnd(T, cap)
    p = ParticleState(torch.remainder(x, 32), torch.remainder(y, 32),
                      *((rnd(T, cap) - 0.5) * 0.4 for _ in range(3)),
                      (slot < 700).float().expand(T, cap) * 0.004)
    ft = FieldState(*((rnd(T, 16, 16) - 0.5) * 0.2 for _ in range(6)))
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8,
              origins=tile_origins(Tiling(tile_rows=4, tile_cols=4, tile_ny=8,
                                          tile_nx=8), dev),
              g=4, dt=0.035, dx=0.1, dy=0.1, grid=(32, 32))
    h = hashlib.sha256()
    for mode, real in (("f32", torch.float32), ("f64", torch.float64)):
        q = type(p)(*(a.to(real).contiguous() for a in p))
        f = type(ft)(*(a.to(real) for a in ft))
        counts = live_watermark(q.w)
        for layout in (q, _shuffled(q, counts)):
            out, _, _ = advance_kernel(layout, f, counts, mode=mode, **kw)
            for a in out:
                h.update(a.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label")
    ap.add_argument("--cells", nargs="+", choices=CELLS, default=CELLS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    run = {"f64": lambda: _headline(dev, "f64"),
           "f32": lambda: _headline(dev, "f32"),
           "laser_plasma": lambda: _laser_plasma(dev),
           "load_balance_stress": lambda: _load_balance_stress(dev)}
    for cell in args.cells:
        print(f"ab {args.label} {cell}: {run[cell]()} [{card}]", flush=True)
        torch.cuda.empty_cache()
    print(f"ab {args.label} fingerprint: {_fingerprint(dev)} [{card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
