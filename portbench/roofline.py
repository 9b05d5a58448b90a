"""The yardsticks of the advance and of the fields: the least time the card
could take for one step's gather, push, move and deposit, or for one step's
field update, from the state's sizes alone, so the count is the same
whatever implements it.

Peaks are the published ones of one NVIDIA H100 SXM (data sheet, dense
rates, at its 700 W limit): 3.35 TB/s of HBM3, 67 TFLOP/s of float32 and
34 TFLOP/s of float64 outside the tensor cores.  A share of the roofline is
stated with the card's power limit beside it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS = {4: 67e12, 8: 34e12}  # by channel width in bytes

# Floating-point operations a particle of the advance needs, by shape order
# (1 CIC, support 2 cells; 2 TSC, support 3), counting add, subtract,
# multiply, divide and square root once each and nothing for floor, abs,
# compare or select:
#   tile-local coordinates                          2
#   gather shapes: 4 supports (x, y; integer and half-integer stagger) of
#     n values, 4 flops a TSC value, 2 a CIC one     TSC 48, CIC 16
#   gather: 6 components, separable, n (n mul + n-1 add) + n mul + n-1 add
#                                                   TSC 120, CIC 54
#   Boris: two half kicks 6 + 3, two gammas 8 + 8, t 6, its norm 7, s 3,
#     the two rotations 12 + 12, the move 6         71
#   shapes at the new position: 2 supports, local coordinates 2
#                                                   TSC 26, CIC 10
#   Esirkepov on the (n+1)^2 union support: ds 2(n+1); Wx and Wy
#     (n+1)^2 + 2(n+1) each; Wz 3(n+1)^2 + 4(n+1); the two prefix sums
#     2 n (n+1); q w scaling 6; the adds into J 3 (n+1)^2
#                                                   TSC 198, CIC 120
ADVANCE_FLOPS = {2: 2 + 48 + 120 + 71 + 26 + 198,
                 1: 2 + 16 + 54 + 71 + 10 + 120}


def advance_bytes(live: float, nx: int, ny: int, width: int) -> float:
    """Bytes one step's advance must move: each live particle's six
    channels read and five written (x, y, three momenta; the weight is not
    written), the six field components read and three J components written
    once each."""
    return width * (11.0 * live + 9.0 * nx * ny)


def advance_flops(live_by_order) -> float:
    """Operations of one step's advance: {shape order: live particles}."""
    return sum(ADVANCE_FLOPS[o] * n for o, n in live_by_order.items())


def advance_least_s(live_by_order, nx: int, ny: int, width: int) -> float:
    """The larger of bytes over bandwidth and operations over the peak."""
    live = sum(live_by_order.values())
    return max(advance_bytes(live, nx, ny, width) / HBM_BYTES_PER_S,
               advance_flops(live_by_order) / FLOPS[width])


def fields_bytes(nx: int, ny: int, width: int, species: bool) -> float:
    """Bytes one step's field update must move: E and B (six components)
    each read and written once over the grid, and where the deck has
    species J's three components read once."""
    return width * nx * ny * (12.0 + (3.0 if species else 0.0))


def fields_least_s(nx: int, ny: int, width: int, species: bool) -> float:
    """Bytes over bandwidth: the update is a few operations a byte."""
    return fields_bytes(nx, ny, width, species) / HBM_BYTES_PER_S
