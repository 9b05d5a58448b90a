"""The step's float64 diagnostics as two reductions: moments and census.

Replaces no TPU kernel (the JAX package's diagnostics are ``jnp``
reductions).  Each has two implementations of one function:

* a CUDA kernel in ``csrc/diag.cu``, launched for CUDA tensors: one pass
  that reads each channel once and sums in float64 registers, with no
  floating-point atomics, so a call repeats bit for bit;
* a plain torch version, taken only for CPU tensors; ``chip_smoke.py`` and
  the card's tests hold each kernel against it.

What each computes:

* **moments** — one species: its kinetic energy ``sum w m (gamma - 1)``
  (0-d) and momentum ``sum w m u`` per axis ([3]), both float64:
  ``core.state.kinetic_energy_plain`` and ``momentum_sum_plain``.  Each
  slot's term rounds as the plain version's; only the order of the sums
  differs.  ``out``, a (0-d, [3]) pair of float64 tensors, receives them in
  place (rows of the step's ``[n_species]`` and ``[n_species, 3]``).
* **census** — the species' live count (``w > 0``, summed over the species,
  int32 [1]); the species flagged in ``checks`` whose live weights are not
  all one value (int32 0-d: the int8 deposit scales jx and jy by
  ``q * max(w)``, right only for uniform w); and, given the fields, their
  energy ``core.state.field_energy_plain`` (float64 0-d).

``core.state``'s ``kinetic_energy``, ``momentum_sum`` and ``field_energy``
take these kernels for CUDA tensors, so the sharded and balanced
simulations take them per shard as the single-device step does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.state import (FieldState, ParticleState, field_energy_plain,
                          kinetic_energy_plain, momentum_sum_plain)
from .advance import _check
from .rebin import _F64, _Kernel, _launched, _stream

# csrc/diag.cu: threads a block, vectors a thread loads at once, species
# the census takes.
THREADS = 256
UNROLL = 4
MAX_SPECIES = 8


class Census(NamedTuple):
    live: torch.Tensor  # int32 [1]: live slots of every species
    nonuniform: torch.Tensor  # int32: checked species with uneven live w
    field_energy: Optional[torch.Tensor]  # float64, None without fields


# ----------------------------------------------------------------------
# Plain torch version of the census (the moments' are core.state's).


def census_plain(species: Sequence[ParticleState], checks: Sequence[bool] = (),
                 fields: Optional[FieldState] = None, dx: float = 1.0,
                 dy: float = 1.0, device=None) -> Census:
    """The census (see the module docstring) in plain torch, on `device`
    when there are no species."""
    dev = species[0].w.device if species else device
    live = torch.zeros((), dtype=torch.int32, device=dev)
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    for i, p in enumerate(species):
        live = live + (p.w > 0).sum(dtype=torch.int32)
        if i < len(checks) and checks[i]:
            wmax = p.w.max()
            inf = torch.full_like(p.w, float("inf"))
            wmin = torch.where(p.w > 0, p.w, inf).min()
            bad = bad + ((wmin != wmax)
                         & torch.isfinite(wmin)).to(torch.int32)
    fe = None if fields is None else field_energy_plain(fields, dx, dy)
    return Census(live.reshape(1), bad, fe)


# ----------------------------------------------------------------------
# CUDA kernels.


class MomentsArgs(ctypes.Structure):
    """Mirror of ``struct MomentsArgs`` in csrc/diag.cu."""

    _fields_ = [("n", ctypes.c_longlong), ("vec", ctypes.c_int),
                ("px", ctypes.c_void_p), ("py", ctypes.c_void_p),
                ("pz", ctypes.c_void_p), ("w", ctypes.c_void_p),
                ("mass", ctypes.c_double), ("ke", ctypes.c_void_p),
                ("mom", ctypes.c_void_p)]


class CensusArgs(ctypes.Structure):
    """Mirror of ``struct CensusArgs`` in csrc/diag.cu."""

    _fields_ = [("w", ctypes.c_void_p * MAX_SPECIES),
                ("n", ctypes.c_longlong * MAX_SPECIES),
                ("vec", ctypes.c_int * MAX_SPECIES),
                ("check", ctypes.c_int * MAX_SPECIES),
                ("ns", ctypes.c_int), ("fvec", ctypes.c_int),
                ("f", ctypes.c_void_p * 6), ("nf", ctypes.c_longlong),
                ("fnx", ctypes.c_longlong), ("fld", ctypes.c_longlong),
                ("dx", ctypes.c_double), ("dy", ctypes.c_double),
                ("live", ctypes.c_void_p), ("bad", ctypes.c_void_p),
                ("fe", ctypes.c_void_p)]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import build

        lib = ctypes.CDLL(str(build("diag.cu").path))
        ci, vp = ctypes.c_int, ctypes.c_void_p
        lib.minipic_moments.argtypes = [ci, MomentsArgs, vp, vp, ci, vp]
        lib.minipic_census.argtypes = [ci, CensusArgs, vp, vp, ci, vp]
        lib.minipic_diag_resident.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.minipic_diag_partials.argtypes = [ci]
        for fn in (lib.minipic_moments, lib.minipic_census,
                   lib.minipic_diag_resident, lib.minipic_diag_partials):
            fn.restype = ci
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _resident(dev: torch.device, f64: int, census: int) -> int:
    """Blocks of a kernel the card holds at once: the most a launch takes."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(dev):
        _launched(_lib().minipic_diag_resident(f64, census,
                                               ctypes.byref(blocks)),
                  "occupancy query")
    return max(1, blocks.value)


@functools.lru_cache(maxsize=None)
def _scratch(dev: torch.device, stream: int) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(partials, counter) of the launches on one stream, made once: the
    launches there run one after another, and each leaves the counter 0."""
    lib = _lib()
    width = max(lib.minipic_diag_partials(0), lib.minipic_diag_partials(1))
    blocks = max(_resident(dev, f, c) for f in (0, 1) for c in (0, 1))
    return (torch.empty(blocks * width, dtype=torch.float64, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _lanes(dtype: torch.dtype) -> int:
    """Channels of `dtype` in a 16-byte vector."""
    return 2 if dtype == torch.float64 else 4


def _grid(dev, f64: int, census: int, vectors: int) -> int:
    """Blocks for `vectors` 16-byte loads: enough that each thread takes
    UNROLL of them, at most what the card holds at once."""
    want = -(-vectors // (THREADS * UNROLL))
    return max(1, min(want, _resident(dev, f64, census)))


def _real(t: torch.Tensor) -> torch.dtype:
    if t.dtype not in _F64:
        raise ValueError(f"channels of {t.dtype}: the diagnostics kernels "
                         "take float32 or float64")
    return t.dtype


class MomentsKernel(_Kernel):
    def __call__(self, p: ParticleState, mass: float,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        dev, real = p.w.device, _real(p.w)
        shape = tuple(p.w.shape)
        chans = (p.px, p.py, p.pz, p.w)
        for name, a in zip(("px", "py", "pz", "w"), chans):
            _check(a, f"p.{name}", real, shape, dev)
        f64 = torch.float64
        if out is None:
            out = (torch.empty((), dtype=f64, device=dev),
                   torch.empty(3, dtype=f64, device=dev))
        _check(out[0], "kinetic out", f64, (), dev)
        _check(out[1], "momentum out", f64, (3,), dev)
        n = p.w.numel()
        vec = _aligned(*chans)
        lanes = _lanes(real)
        args = MomentsArgs(n, int(vec), *(a.data_ptr() for a in chans),
                           float(mass), out[0].data_ptr(), out[1].data_ptr())
        stream = _stream(dev)
        partials, counter = _scratch(dev, stream)
        blocks = _grid(dev, _F64[real], 0, n // lanes if vec else n)
        _launched(_lib().minipic_moments(
            _F64[real], args, partials.data_ptr(), counter.data_ptr(),
            blocks, stream), "moments")
        self.launches += 1
        return out


class CensusKernel(_Kernel):
    def __call__(self, species: Sequence[ParticleState],
                 checks: Sequence[bool] = (),
                 fields: Optional[FieldState] = None, dx: float = 1.0,
                 dy: float = 1.0, device=None) -> Census:
        if len(species) > MAX_SPECIES:
            raise ValueError(f"{len(species)} species; the census takes at "
                             f"most {MAX_SPECIES}")
        first = species[0].w if species else (
            None if fields is None else fields.ex)
        dev = first.device if first is not None else torch.device(device)
        real = torch.float32 if first is None else _real(first)
        args = CensusArgs()
        args.ns = len(species)
        vectors = 0
        lanes = _lanes(real)
        for s, p in enumerate(species):
            _check(p.w, f"species {s} w", real, tuple(p.w.shape), dev)
            args.w[s] = p.w.data_ptr()
            args.n[s] = p.w.numel()
            args.vec[s] = int(_aligned(p.w))
            args.check[s] = int(s < len(checks) and bool(checks[s]))
            vectors += p.w.numel() // lanes if args.vec[s] else p.w.numel()
        live = torch.empty(1, dtype=torch.int32, device=dev)
        bad = torch.empty((), dtype=torch.int32, device=dev)
        fe = None
        if fields is not None:
            ny, nx = fields.ex.shape
            for name, c in zip(FieldState._fields, fields):
                if (c.device != dev or c.dtype != real
                        or tuple(c.shape) != (ny, nx)
                        or c.stride() != fields.ex.stride()
                        or c.stride(1) != 1):
                    raise ValueError(
                        f"field {name}: need {real} ({ny}, {nx}) on {dev} "
                        f"with unit column stride and ex's strides, got "
                        f"{c.dtype} {tuple(c.shape)} on {c.device}, strides "
                        f"{c.stride()}")
            fe = torch.empty((), dtype=torch.float64, device=dev)
            ld = fields.ex.stride(0)
            args.fvec = int(ld == nx and _aligned(*fields))
            args.f = (ctypes.c_void_p * 6)(*(c.data_ptr() for c in fields))
            args.nf, args.fnx, args.fld = ny * nx, nx, ld
            args.dx, args.dy = float(dx), float(dy)
            args.fe = fe.data_ptr()
            vectors += 6 * (ny * nx // lanes if args.fvec else ny * nx)
        args.live, args.bad = live.data_ptr(), bad.data_ptr()
        stream = _stream(dev)
        partials, counter = _scratch(dev, stream)
        blocks = _grid(dev, _F64[real], 1, vectors)
        _launched(_lib().minipic_census(
            _F64[real], args, partials.data_ptr(), counter.data_ptr(),
            blocks, stream), "census")
        self.launches += 1
        return Census(live, bad, fe)


moments_kernel = MomentsKernel()
census_kernel = CensusKernel()
KERNELS = {"moments": moments_kernel, "census": census_kernel}


# ----------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors.


def _on_cpu(a: torch.Tensor, what: str) -> None:
    if a.device.type != "cpu":
        raise ValueError(f"no {what} for device {a.device}")


def moments(p: ParticleState, mass: float,
            out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kinetic energy, momentum [3]) of one species, float64, written into
    `out` when given."""
    if p.w.is_cuda:
        return moments_kernel(p, mass, out)
    _on_cpu(p.w, "moments")
    ke, mom = kinetic_energy_plain(p, mass), momentum_sum_plain(p, mass)
    if out is None:
        return ke, mom
    out[0].copy_(ke)
    out[1].copy_(mom)
    return out


def census(species: Sequence[ParticleState], checks: Sequence[bool] = (),
           fields: Optional[FieldState] = None, dx: float = 1.0,
           dy: float = 1.0, device=None) -> Census:
    """The census of `species` (and of `fields` when given); `device` is
    where its outputs go when there are no species."""
    first = species[0].w if species else (
        None if fields is None else fields.ex)
    on_card = (first.is_cuda if first is not None else
               device is not None and torch.device(device).type == "cuda")
    if on_card:
        return census_kernel(species, checks, fields, dx, dy, device)
    if first is not None:
        _on_cpu(first, "census")
    return census_plain(species, checks, fields, dx, dy, device)
