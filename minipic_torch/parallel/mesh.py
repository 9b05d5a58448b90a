"""A single-controller device mesh, and the collectives over it.

The JAX package drives all its devices from one Python program: particle
and field arrays are sharded over a 2-D ``jax.sharding.Mesh`` with axes
('ry', 'rx'), and the collectives inside ``shard_map`` are ``ppermute``,
``psum``, ``pmax`` and ``all_gather``.  The port keeps that model: one
process holds R x C shard states, each on a ``torch.device`` of its own,
and the collectives are explicit moves of tensors between the shards'
devices.  Entries may repeat: with every shard on one card the seams, hops
and gathers all run for real on it, and with four cards the same code
places two shards on each.

Each collective takes a list with one tensor per shard, in row-major mesh
order (shard s at mesh coordinate (s // C, s % C)), and returns such a
list, each result on its shard's device.  A move to another device is
``Tensor.to(device, non_blocking=True)``, which PyTorch orders after the
work queued on the source's stream; a "move" on the same device is the
tensor itself, so the receiver must not write into what it received.

Every hand-off between devices goes through ``move``, which counts it on
the host (``trace.count``, with the recorder on: ``parallel.peer_copies``
and the bytes handed, ``parallel.peer_bytes``).  The reductions and the
gather open the ``minipic.parallel`` span themselves, and so does
``move_all``, which hands a list of tensors to one device.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..core.config import Deck
from ..trace import count, span

AXES = ("ry", "rx")
# Layer span (a profiler range while a profiler runs) of the collectives:
# the halo exchange and fold, particle routing, the gathers and the J sum.
PARALLEL_RANGE = "minipic.parallel"
# Counters of ``move``: the tensors handed to another device, and their bytes.
PEER_COPIES = "parallel.peer_copies"
PEER_BYTES = "parallel.peer_bytes"
# Shards of a mesh on the CPU when the deck names no mesh_shape: the JAX
# package's test harness runs 8 virtual CPU devices.
CPU_SHARDS = 8


class Mesh:
    """R x C grid of devices (repeats allowed), row-major."""

    def __init__(self, devices: Sequence, rows: int, cols: int):
        if len(devices) != rows * cols:
            raise ValueError(f"mesh {rows}x{cols} != {len(devices)} devices")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.shape: Tuple[int, int] = (rows, cols)

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, s: int) -> Tuple[int, int]:
        return divmod(s, self.shape[1])

    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in order of first appearance."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def collective(fn: Callable) -> Callable:
    """Run `fn` inside the PARALLEL_RANGE span."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with span(PARALLEL_RANGE):
            return fn(*args, **kw)
    return wrapped


def on(device: torch.device):
    """Context that makes `device` current for kernel launches (a CUDA
    kernel launches on the current device's context)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def default_devices(deck: Deck, device=None) -> List[torch.device]:
    """The shards' devices when the caller names none: the deck's
    mesh_shape shards (else one per visible card), laid round-robin over
    cuda:0..count-1; with `device` given, every shard on it (on the CPU,
    CPU_SHARDS of them unless the deck names a mesh_shape)."""
    if deck.mesh_shape is not None:
        n = deck.mesh_shape[0] * deck.mesh_shape[1]
    else:
        n = None
    if device is not None:
        device = torch.device(device)
        if n is None:
            n = (CPU_SHARDS if device.type == "cpu"
                 else max(1, torch.cuda.device_count()))
        return [device] * n
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh defaults to the cards but CUDA is not "
                           "available; pass device='cpu' (or devices=)")
    count = torch.cuda.device_count()
    n = count if n is None else n
    return [torch.device("cuda", i % count) for i in range(n)]


def make_mesh(deck: Deck, devices: Optional[Sequence] = None, *,
              device=None) -> Mesh:
    """The R x C mesh of `devices` (default_devices by default), R x C from
    ``deck.mesh_dims``; the tile grid must divide over it."""
    devices = list(devices if devices is not None
                   else default_devices(deck, device))
    r, c = deck.mesh_dims(len(devices))
    if r * c != len(devices):
        raise ValueError(f"mesh {r}x{c} != {len(devices)} devices")
    t = deck.tiling
    if t.tile_rows % r or t.tile_cols % c:
        raise ValueError(f"tile grid {t.tile_rows}x{t.tile_cols} not "
                         f"divisible by mesh {r}x{c}")
    return Mesh(devices, r, c)


def shard_shape(deck: Deck, mesh: Mesh) -> Tuple[int, int]:
    r, c = mesh.shape
    return deck.ny // r, deck.nx // c


def local_tile_grid(deck: Deck, mesh: Mesh) -> Tuple[int, int]:
    r, c = mesh.shape
    t = deck.tiling
    return t.tile_rows // r, t.tile_cols // c


# ----------------------------------------------------------------------
# Collectives.


def move(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`x` on `device`: `x` itself where it lies there, else a copy,
    counted (host only: no read, no launch)."""
    if x.device == device:
        return x
    count(PEER_COPIES)
    count(PEER_BYTES, x.nbytes)
    return x.to(device, non_blocking=True)


@collective
def move_all(xs: Sequence[torch.Tensor],
             device: torch.device) -> List[torch.Tensor]:
    """Each of `xs` on `device` (``move``)."""
    return [move(x, device) for x in xs]


def shift(xs: Sequence[torch.Tensor], mesh: Mesh, axis: str,
          up: bool) -> List[torch.Tensor]:
    """One periodic mesh step along `axis` ('ry' or 'rx'), the ``ppermute``
    of the JAX package's ``halo._shift``: up=True sends toward lower
    indices (shard i receives from i + 1), up=False toward higher ones."""
    rows, cols = mesh.shape
    n = cols if axis == "rx" else rows
    if n == 1:
        return list(xs)
    step = 1 if up else -1
    out = []
    for s in range(mesh.size):
        r, c = mesh.coords(s)
        if axis == "rx":
            src = r * cols + (c + step) % cols
        else:
            src = ((r + step) % rows) * cols + c
        out.append(move(xs[src], mesh.devices[s]))
    return out


def _reduce(xs: Sequence[torch.Tensor], mesh: Mesh,
            op: Callable) -> List[torch.Tensor]:
    """`op` over every shard's tensor, in shard order, computed once on
    each distinct device and handed to its shards."""
    done = {}
    for d in mesh.distinct():
        acc = move(xs[0], d)
        for x in xs[1:]:
            acc = op(acc, move(x, d))
        done[d] = acc
    return [done[d] for d in mesh.devices]


@collective
def psum(xs, mesh: Mesh) -> List[torch.Tensor]:
    return _reduce(xs, mesh, torch.add)


@collective
def pmax(xs, mesh: Mesh) -> List[torch.Tensor]:
    return _reduce(xs, mesh, torch.maximum)


@collective
def pall(xs, mesh: Mesh) -> List[torch.Tensor]:
    """Logical AND of 0-d bool tensors over the mesh (the JAX package's
    ``psum(ok) == n`` agreement)."""
    return _reduce(xs, mesh, torch.logical_and)


@collective
def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh,
               dim: int = 0) -> List[torch.Tensor]:
    """Every shard's tensor concatenated along `dim` in shard order,
    materialised once per distinct device."""
    done = {d: torch.cat([move(x, d) for x in xs], dim=dim)
            for d in mesh.distinct()}
    return [done[d] for d in mesh.devices]
