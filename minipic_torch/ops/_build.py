"""Build the CUDA sources of this package into shared libraries at first use.

``nvcc`` compiles one source of ``csrc/`` (a plain C entry point, no
PyTorch headers: seconds, not minutes) into
``minipic_torch/_build/<hash>/lib<stem>.so``, keyed by a hash of the
source and flags, so an edited source rebuilds and an unchanged one loads
the library already built.  The build directory is listed in
``.gitignore``.  Each source builds on its own, so several can build at
once (one ``nvcc`` each).

Flags: ``--fmad=false`` (no contracted multiply-add; the int8 deposit's
bit-exact s1 -> s0 telescoping needs it) and no ``--use_fast_math``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Union

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("advance.cu", "rebin.cu", "diag.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


class Built(NamedTuple):
    path: Path
    seconds: float  # spent in nvcc; 0.0 when the library was already built
    log: str  # the compiler's output (ptxas register and spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")


def build(src: Union[str, Path]) -> Built:
    """The built library of `src` (a file name in ``csrc/``, or the path of
    another source: probe_atomics builds a variant), compiling it if
    needed."""
    src = CSRC / src if isinstance(src, str) else Path(src)
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / key
    lib = out_dir / f"lib{src.stem}.so"
    if lib.exists():
        return Built(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name} ({r.returncode}):\n"
                           f"{r.stdout}\n{r.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return Built(lib, seconds, r.stdout + r.stderr)
