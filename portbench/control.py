"""The readings a cell's limits are set from: on each seed, one run of the
cell with a short window, and at each step the check judges, the numbers
compared for the program and for the control (the reference in the
precision below the deck's, put in the program's place).  Not part of the
benchmark's runs.

    python3 -m portbench.control --workload <cell> --seconds 3 \\
        --seeds <n> [<n> ...]

prints one JSON line a seed: {"seed", "program": [reading a step],
"control": [reading a step]}.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import cell


def readings(name: str, seed: int, seconds: float, device,
             workload=None, config=None) -> dict:
    if workload is None:
        workload, config = cell.cell_files(name)
    deck = cell.deck_dict(config, workload)
    sim = cell.Sim(deck, config, workload, seed, device, cell.cell_chips(
        cell.load_json(cell.BENCHMARK), name))
    i = cell.warm_up(sim)
    window = cell.drive(sim, seconds, i)
    last, next_i = window.last, window.next_i
    window = None
    out = {"seed": seed, "program": [], "control": []}
    for r in cell.step_readings(sim, last, next_i, config,
                                ("program", "control")):
        out["program"].append(r["program"])
        out["control"].append(r["control"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, args.seconds, dev)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
