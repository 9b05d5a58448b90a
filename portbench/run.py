"""The benchmark of minipic_torch on one NVIDIA H100: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout: it makes the cell's inputs from the seed,
builds (or loads) the program's kernels, warms up, steps the cell through
``Simulation.run_step`` for the given seconds, and prints one JSON object as
the last line of standard output: ``correct`` (the program's steps against
the plain reference, ``portbench/reference``), ``attempted`` and ``failed``
(items judged: the steps held to the reference and, in a periodic deck,
the window's live count; items outside a limit), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones from a profiler trace),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard error).

It exits with another code and prints no result without a CUDA card, on a
card it cannot use, when the program cannot be imported, or when a module
of JAX or of the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Imports the run must never hold, compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "minipic_tpu")


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that are JAX or the JAX package."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _cache_dirs(root: Path) -> None:
    """Kernel caches inside the checkout, at fixed paths: the program
    builds its own into ``minipic_torch/_build``; Triton's and PyTorch's
    extension caches, should anything use them, go beside it."""
    cache = root / "portbench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    _cache_dirs(root)

    import torch

    from . import cell

    # One host thread for the CPU side of the step: idle pool threads
    # spinning beside the launching thread only add noise.
    torch.set_num_threads(1)

    bench = cell.load_json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < entry["chips"]:
        print(f"cell {args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    workload, config = cell.cell_files(args.workload)
    result = cell.run_cell(args.workload, workload, config, args.seed,
                           args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START, bench=bench)
    found = forbidden_modules()
    if found:
        print(f"loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
