"""Cross-shard guard-cell exchange and its additive adjoint (torch port of
``minipic_tpu.parallel.halo``).

Two axis-shift passes replace the reference's 8-direction enumeration:
exchanging x-edge strips first and then y-edge strips of the x-padded
block delivers the corners in two hops.  ``fold_halo`` is the adjoint (y,
then x), which adds deposition guard rings into the neighbours' interiors.

Both take one tensor per shard (``mesh.shift``'s list convention); leading
axes (a stacked component axis) ride along.  On a mesh axis of size 1 the
shift is the identity, which is the periodic wrap.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .mesh import Mesh, collective, shift


@collective
def exchange_halo(blocks: Sequence[torch.Tensor], g: int,
                  mesh: Mesh) -> List[torch.Tensor]:
    """Local blocks [..., ny_l, nx_l] -> [..., ny_l+2g, nx_l+2g] with guard
    rings from the mesh neighbours (periodic)."""
    # x: my right halo is my right neighbour's left edge.
    right = shift([b[..., :, :g] for b in blocks], mesh, "rx", up=True)
    left = shift([b[..., :, -g:] for b in blocks], mesh, "rx", up=False)
    xp = [torch.cat([lh, b, rh], dim=-1)
          for lh, b, rh in zip(left, blocks, right)]
    # y: strips of the x-padded block, so the corners arrive in two hops.
    bot = shift([a[..., :g, :] for a in xp], mesh, "ry", up=True)
    top = shift([a[..., -g:, :] for a in xp], mesh, "ry", up=False)
    return [torch.cat([th, a, bh], dim=-2) for th, a, bh in zip(top, xp, bot)]


@collective
def fold_halo(padded: Sequence[torch.Tensor], g: int,
              mesh: Mesh) -> List[torch.Tensor]:
    """Additive adjoint of exchange_halo: [..., ny_l+2g, nx_l+2g] ->
    [..., ny_l, nx_l]; each guard ring is added into the interior edge of
    the neighbour that owns those cells."""
    # y first.  My bottom interior rows are my lower neighbour's top ring.
    from_below = shift([p[..., :g, :] for p in padded], mesh, "ry", up=True)
    from_above = shift([p[..., -g:, :] for p in padded], mesh, "ry",
                       up=False)
    mids = []
    for p, fb, fa in zip(padded, from_below, from_above):
        mid = p[..., g:-g, :].clone()
        mid[..., -g:, :] += fb
        mid[..., :g, :] += fa
        mids.append(mid)
    # x: my right interior columns take my right neighbour's left ring.
    from_right = shift([m[..., :, :g] for m in mids], mesh, "rx", up=True)
    from_left = shift([m[..., :, -g:] for m in mids], mesh, "rx", up=False)
    out = []
    for m, fr, fl in zip(mids, from_right, from_left):
        o = m[..., :, g:-g].clone()
        o[..., :, -g:] += fr
        o[..., :, :g] += fl
        out.append(o)
    return out
