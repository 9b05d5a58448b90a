"""The headline configuration on the port.

``headline_deck()`` is bench.py:58-102's deck exactly (1e8 electrons on
512^2, 8x8 tiles, guard 4, TSC, int8 deposit, whole-bucket chunks,
headroom 1.1, ``rebin_mode`` at its default "auto": the deal-route
re-bin).  ``headline_deck(rebin_mode="sort")`` drives the sort re-bin
instead.

A profile of a deck's step: ``minipic-torch --deck NAME --profile DIR``
(``--sharded`` / ``--balanced`` for a mesh); of the headline's, the
benchmark's traced run, ``python3 -m portbench.run --workload
headline-int8 --seed N --seconds S --trace 1``.
"""
from __future__ import annotations

from .core.config import Deck, SpeciesSpec


def headline_deck(grid: int = 512, order: int = 2,
                  rebin_mode: str = "auto") -> Deck:
    """bench.py's deck with ppc = round(1e8 / 512^2) = 381; `grid` cuts the
    box (not the widths) for smaller runs."""
    ppc = max(1, round(1e8 / 512 ** 2))
    return Deck(
        box_x=grid / 10.0, box_y=grid / 10.0, nx=grid, ny=grid, tile_nx=8,
        tile_ny=8, guard=4,
        species=(SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.05,
                             shape_order=order),),
        precision="f32", rebin_interval=8, capacity_headroom=1.1, kchunk=0,
        deposit="int8", rebin_mode=rebin_mode)

