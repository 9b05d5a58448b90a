"""The f32 headline deck on one card, for an A/B of two trees.

    python3 path/to/ab_headline.py LABEL

run from the root of a checkout times THAT checkout's package (the working
directory comes first on the import path), so one script times a parent
tree and a change in turns (parent, change, change, parent, ...), each in a
process of its own.  It steps ``headline_deck()`` (bench.py's deck, the
int8 deposit) 60 times from the seed-0 load with a host clock around each
synchronized step, then times the advance kernel alone on the final state
in its int8 and f32 modes (CUDA events over 5 launches), and prints one
line: ms/step (mean), the advance-only steps' median, and the two advance
times.  Build the kernels first (``chip_smoke.phase_build``): a first
launch that compiles lands in the first step.
"""
import statistics
import sys
import time

sys.path.insert(0, ".")
import torch  # noqa: E402

from minipic_torch.fields.halo import pad_fields_periodic  # noqa: E402
from minipic_torch.fields.tiles import extract_field_tiles  # noqa: E402
from minipic_torch.headline import headline_deck  # noqa: E402
from minipic_torch.ops.advance import advance_kernel, live_watermark  # noqa
from minipic_torch.simulation import Simulation, tile_origins  # noqa: E402


def main() -> int:
    label = sys.argv[1] if len(sys.argv) > 1 else "run"
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    deck = headline_deck()
    sim = Simulation(deck, seed=0, device=dev)
    torch.cuda.synchronize()
    adv_ms, rebin_ms = [], []
    for _ in range(60):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        (rebin_ms if float(sim.state.drift) == 0.0 else adv_ms).append(ms)
    t, g = deck.tiling, deck.guard
    ft = extract_field_tiles(pad_fields_periodic(sim.state.fields, g),
                             t.tile_rows, t.tile_cols, t.tile_ny, t.tile_nx,
                             g)
    p = sim.state.species[0]
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=t.tile_ny, tile_nx=t.tile_nx,
              origins=tile_origins(t, dev), g=g, dt=deck.dt, dx=deck.dx,
              dy=deck.dy, grid=(deck.nx, deck.ny))
    adv = {}
    for mode in ("int8", "f32"):
        advance_kernel(p, ft, counts, mode=mode, **kw)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(5):
            advance_kernel(p, ft, counts, mode=mode, **kw)
        b.record()
        torch.cuda.synchronize()
        adv[mode] = a.elapsed_time(b) / 5
    print(f"ab {label}: ms/step {statistics.mean(adv_ms + rebin_ms):.3f} "
          f"mean, advance-only median {statistics.median(adv_ms):.3f} over "
          f"{len(adv_ms)}, re-bin steps {len(rebin_ms)}; advance int8 "
          f"{adv['int8']:.3f} ms, f32 {adv['f32']:.3f} ms at the final state "
          f"[{torch.cuda.get_device_name(0)}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
