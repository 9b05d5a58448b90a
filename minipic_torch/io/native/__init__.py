"""ctypes binding of the native asynchronous snapshot writer (the port's own
copy of ``minipic_tpu.io.native``).

``snapshot_writer.cpp`` is built with ``g++`` at first use into
``minipic_torch/_build/<hash>/libmpw.so`` (git-ignored; the hash covers
the source, the flags and the libhdf5 runtime it links), never beside
the source.  It links only the system libhdf5 runtime, through prototypes
declared by hand in the source (no HDF5 headers needed).
``AsyncSnapshotWriter.submit`` cuts the tile windows on the device
(``io.hdf5.tile_windows``), copies them to the host once and hands each
rank's buffer to the C++ thread pool, which writes the files while the
run goes on; ``flush`` waits for them.  ``available()`` is False where
g++ or the runtime is missing; callers then take the h5py writer
(``io/hdf5.py``), whose files are the same.
"""
from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from ...core.geometry import Tiling
from ..hdf5 import (block_owner, field_file, particle_buffer, particle_file,
                    tile_windows)

_SRC = Path(__file__).resolve().parent / "snapshot_writer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
HDF5_RUNTIMES = (
    "/lib/x86_64-linux-gnu/libhdf5_serial.so.103",
    "/usr/lib/x86_64-linux-gnu/libhdf5_serial.so.103",
    "/usr/lib/x86_64-linux-gnu/libhdf5_serial.so",
)
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _find_hdf5() -> Optional[str]:
    for cand in HDF5_RUNTIMES:
        if os.path.exists(cand):
            return cand
    return None


def _build() -> Optional[ctypes.CDLL]:
    hdf5 = _find_hdf5()
    if hdf5 is None:
        return None
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS + (hdf5,))
                         .encode()).hexdigest()[:16]
    out = BUILD_DIR / key / "libmpw.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = ["g++", *GXX_FLAGS, str(_SRC), hdf5, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            os.unlink(tmp)
            return None
        os.replace(tmp, out)  # a concurrent loader sees all or nothing
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    lib.mpw_init.argtypes = [ctypes.c_int]
    lib.mpw_init.restype = ctypes.c_int
    lib.mpw_submit.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32), ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_longlong, ctypes.c_longlong,
    ]
    lib.mpw_submit.restype = ctypes.c_int
    lib.mpw_submit_particles.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    lib.mpw_submit_particles.restype = ctypes.c_int
    lib.mpw_flush.argtypes = []
    lib.mpw_flush.restype = ctypes.c_int
    lib.mpw_written.argtypes = []
    lib.mpw_written.restype = ctypes.c_long
    lib.mpw_shutdown.argtypes = []
    lib.mpw_shutdown.restype = None
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        _LIB = _build()
        if _LIB is not None and _LIB.mpw_init(2) != 0:
            _LIB = None
        if _LIB is not None:
            # Joinable std::threads at static destruction call terminate():
            # drain and join at interpreter exit instead.
            atexit.register(_LIB.mpw_shutdown)
    return _LIB


def available() -> bool:
    """True when the writer builds (g++ and a libhdf5 runtime) and starts."""
    return _get() is not None


class AsyncSnapshotWriter:
    """Reference-schema snapshot writer with serialization on background
    threads; the files equal ``io.hdf5.save_fields`` / ``save_particles``'
    ones."""

    def __init__(self, tiling: Tiling, guard: int, folder: str,
                 ranks: int = 1):
        self.lib = _get()
        if self.lib is None:
            raise RuntimeError("native writer unavailable (no g++ or "
                               "libhdf5 runtime)")
        self.tiling = tiling
        self.guard = guard
        self.folder = folder
        self.ranks = ranks
        self.owner = block_owner(tiling, ranks)
        os.makedirs(folder, exist_ok=True)

    def submit(self, fields, step: int) -> None:
        """Cut and copy the windows, enqueue one file per rank; returns
        without waiting for the files."""
        t, g = self.tiling, self.guard
        windows = tile_windows(fields, t, g)
        for r in range(self.ranks):
            gids = np.nonzero(self.owner == r)[0].astype(np.int32)
            data = np.ascontiguousarray(windows[gids])
            rc = self.lib.mpw_submit(
                field_file(self.folder, r, step).encode(), len(gids), gids,
                (gids // t.tile_cols).astype(np.int32),
                (gids % t.tile_cols).astype(np.int32), r, data,
                t.tile_ny + 2 * g, t.tile_nx + 2 * g)
            if rc != 0:
                raise RuntimeError("native writer submit failed")

    def submit_particles(self, species_states, species_names,
                         step: int) -> None:
        """Enqueue a particle snapshot (``particles_rank_0_step_{s}.h5``,
        the schema of ``io.hdf5.save_particles``); returns without waiting
        for the file."""
        counts, data = particle_buffer(species_states)
        names = (ctypes.c_char_p * len(species_names))(
            *(n.encode() for n in species_names))
        rc = self.lib.mpw_submit_particles(
            particle_file(self.folder, step).encode(), len(species_names),
            names, np.asarray(counts, np.int64), data)
        if rc != 0:
            raise RuntimeError("native writer particle submit failed")

    def flush(self) -> int:
        """Wait for the queue to drain; returns the number of failed files."""
        return self.lib.mpw_flush()

    def written(self) -> int:
        return self.lib.mpw_written()
