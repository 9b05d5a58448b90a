"""HDF5 snapshots in the reference's schema (the port's own copy of
``minipic_tpu.io.hdf5``; the same files, dataset for dataset).

Schema (reference ``HDF5_output.cpp:10-79``):

* file ``fields_rank_{r}_step_{s}.h5`` per rank per saved step;
* one group ``/Tile_{globalID}`` per tile;
* dataset ``fields``: compound dtype {Ex,Ey,Ez,Bx,By,Bz} (6 x f8), shape
  (tile_ny + 2 guard, tile_nx + 2 guard), guard cells included, the guard
  ring a periodic wrap of the global grid (for decks with absorbing walls
  too, as the JAX package writes it);
* scalar int attributes ``tileRow``, ``tileCol``, ``currentRank``.

The reference's post-processor (``File_reader.py:57-119``) reads this
layout.  A "rank" is a presentation of the one global state: the writer
fans the tiles out over any rank grid (default 1).

The tile windows are cut on the device (``tile_windows``: the step's own
periodic pad and window extract, stacked as [T, nyg, nxg, 6] float64) and
copied to the host once per snapshot; that array is also the native
writer's layout (``io/native``).  Particle snapshots
(``particles_rank_0_step_{s}.h5``) hold each species' live particles,
compacted on the device and copied once.  h5py is imported inside the
functions that write or read files.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.geometry import Tiling, find_best_grid
from ..core.state import FieldState
from ..fields.halo import pad_block_periodic
from ..fields.tiles import extract_tiles

GRID_DTYPE = np.dtype(
    [("Ex", "<f8"), ("Ey", "<f8"), ("Ez", "<f8"), ("Bx", "<f8"),
     ("By", "<f8"), ("Bz", "<f8")]
)
PARTICLE_CHANNELS = ("x", "y", "px", "py", "pz", "w")


def available() -> bool:
    """True when h5py can be imported (the synchronous writer's need)."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def tile_windows(fields: FieldState, tiling: Tiling,
                 guard: int) -> np.ndarray:
    """Every tile's interior plus its periodic guard ring, as a host array
    [num_tiles, tile_ny + 2 guard, tile_nx + 2 guard, 6] of float64 in
    global tile-ID order, components Ex..Bz last: cut and stacked on the
    fields' device, then copied once."""
    g, t = guard, tiling
    wins = [extract_tiles(pad_block_periodic(c, g), t.tile_rows, t.tile_cols,
                          t.tile_ny, t.tile_nx, g) for c in fields]
    stack = torch.stack(wins, dim=-1).to(torch.float64)
    return stack.reshape(t.num_tiles, t.tile_ny + 2 * g, t.tile_nx + 2 * g,
                         6).cpu().numpy()


def block_owner(tiling: Tiling, ranks: int) -> np.ndarray:
    """[num_tiles] tile -> rank map of the near-square rank grid's blocks
    (reference ``PIC_2D.cpp:29-52``)."""
    rr, rc = find_best_grid(ranks)
    if tiling.tile_rows % rr or tiling.tile_cols % rc:
        raise ValueError(f"rank grid {rr}x{rc} must divide tile grid")
    gid = np.arange(tiling.num_tiles)
    row, col = gid // tiling.tile_cols, gid % tiling.tile_cols
    return (row // (tiling.tile_rows // rr)) * rc + col // (tiling.tile_cols
                                                            // rc)


def field_file(folder: str, rank: int, step: int) -> str:
    return os.path.join(folder, f"fields_rank_{rank}_step_{step}.h5")


def particle_file(folder: str, step: int) -> str:
    return os.path.join(folder, f"particles_rank_0_step_{step}.h5")


def write_field_file(path: str, windows: np.ndarray, gids: Sequence[int],
                     tile_cols: int, rank: int) -> None:
    """One rank's file: the groups of tiles `gids` from ``tile_windows``'
    array."""
    import h5py

    data = windows.view(GRID_DTYPE)[..., 0]
    with h5py.File(path, "w") as f:
        for gid in gids:
            gid = int(gid)
            grp = f.create_group(f"Tile_{gid}")
            grp.create_dataset("fields", data=data[gid])
            grp.attrs.create("tileRow", gid // tile_cols, dtype="<i4")
            grp.attrs.create("tileCol", gid % tile_cols, dtype="<i4")
            grp.attrs.create("currentRank", rank, dtype="<i4")


def save_fields(
    fields: FieldState,
    tiling: Tiling,
    guard: int,
    step: int,
    folder: str,
    ranks: int = 1,
    owner: Optional[np.ndarray] = None,
) -> list:
    """Write the reference-schema snapshot of one step.

    ranks: fan the tiles out over this many per-rank files (the
    near-square rank grid's blocks).  owner: an optional [num_tiles]
    tile -> rank map in place of the blocks (tiles placed elsewhere, as
    after a migration; ``File_reader`` reads it, since placement travels
    in the attributes)."""
    os.makedirs(folder, exist_ok=True)
    blocks = block_owner(tiling, ranks)
    owner = blocks if owner is None else owner
    windows = tile_windows(fields, tiling, guard)
    paths = []
    for r in range(ranks):
        path = field_file(folder, r, step)
        write_field_file(path, windows, np.nonzero(owner == r)[0],
                         tiling.tile_cols, r)
        paths.append(path)
    return paths


def particle_buffer(species_states) -> Tuple[List[int], np.ndarray]:
    """Each species' live particles (w > 0) in flat slot order, channels
    x, y, px, py, pz, w one after the other, species after species, as one
    float64 host array (one copy; one count read per species).  Returns
    (live counts, array)."""
    parts, counts = [], []
    for p in species_states:
        idx = (p.w.reshape(-1) > 0).nonzero().squeeze(1)
        counts.append(int(idx.numel()))
        parts.extend(getattr(p, c).reshape(-1)[idx].to(torch.float64)
                     for c in PARTICLE_CHANNELS)
    if not parts:
        return counts, np.zeros(0)
    return counts, torch.cat(parts).cpu().numpy()


def save_particles(species_states, species_names, step: int,
                   folder: str) -> str:
    """Particle snapshot (the native writer's ``submit_particles`` writes
    the same schema): ``particles_rank_0_step_{s}.h5``, one group per
    species holding live-compacted 1-D f8 datasets x, y, px, py, pz, w and
    an int ``count`` attribute.  The reference wrote fields only; this
    extends its per-rank snapshot convention to the particles."""
    import h5py

    os.makedirs(folder, exist_ok=True)
    counts, data = particle_buffer(species_states)
    path = particle_file(folder, step)
    off = 0
    with h5py.File(path, "w") as f:
        for name, n in zip(species_names, counts):
            grp = f.create_group(name)
            for c in PARTICLE_CHANNELS:
                grp.create_dataset(c, data=data[off:off + n])
                off += n
            grp.attrs.create("count", n, dtype="<i4")
    return path


class SnapshotWriter:
    """The h5py writer behind the native writer's interface
    (``io.native.AsyncSnapshotWriter``): each submit writes its files
    before it returns, so ``flush`` has nothing to wait for."""

    def __init__(self, tiling: Tiling, guard: int, folder: str,
                 ranks: int = 1):
        block_owner(tiling, ranks)  # the rank grid must divide the tiles
        self.tiling, self.guard, self.folder = tiling, guard, folder
        self.ranks = ranks

    def submit(self, fields: FieldState, step: int) -> None:
        save_fields(fields, self.tiling, self.guard, step, self.folder,
                    ranks=self.ranks)

    def submit_particles(self, species_states, species_names,
                         step: int) -> None:
        save_particles(species_states, species_names, step, self.folder)

    def flush(self) -> int:
        return 0


def load_field(
    step: int,
    folder: str,
    quantity: str = "Ex",
    *,
    nx_global: int,
    ny_global: int,
    guard: int,
    interior_nx: int,
    interior_ny: int,
) -> np.ndarray:
    """Reassemble one global component from a step's per-rank files, as
    the reference's reader does (``File_reader.py:57-119``): strip the
    guards, put each tile's interior at (tileRow*interior_ny,
    tileCol*interior_nx)."""
    import h5py

    out = np.zeros((ny_global, nx_global), np.float64)
    files = glob.glob(os.path.join(folder, f"fields_rank_*_step_{step}.h5"))
    if not files:
        raise FileNotFoundError(f"no snapshot files for step {step} in "
                                f"{folder}")
    for path in files:
        with h5py.File(path, "r") as f:
            for gname, grp in f.items():
                if not gname.startswith("Tile_"):
                    continue
                trow = int(grp.attrs["tileRow"])
                tcol = int(grp.attrs["tileCol"])
                data = grp["fields"][guard:-guard, guard:-guard][quantity]
                out[
                    trow * interior_ny:(trow + 1) * interior_ny,
                    tcol * interior_nx:(tcol + 1) * interior_nx,
                ] = data
    return out


def load_particles(step: int, folder: str) -> Dict[str, Dict[str, np.ndarray]]:
    """One particle snapshot -> {species: {x, y, px, py, pz, w}}."""
    import h5py

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(particle_file(folder, step), "r") as f:
        for name, grp in f.items():
            out[name] = {k: grp[k][:] for k in PARTICLE_CHANNELS}
            if len(out[name]["x"]) != int(grp.attrs["count"]):
                raise ValueError(f"species {name}: count attribute "
                                 f"{int(grp.attrs['count'])} != "
                                 f"{len(out[name]['x'])} particles")
    return out


def available_steps(folder: str) -> list:
    steps = set()
    for p in glob.glob(os.path.join(folder, "fields_rank_*_step_*.h5")):
        m = re.search(r"_step_(\d+)\.h5$", p)
        if m:
            steps.add(int(m.group(1)))
    return sorted(steps)
