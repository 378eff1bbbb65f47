"""Peaks of one NVIDIA H100 SXM and the least time a piece of work can
take on it (a frozen copy of `repro_torch/obs/roofline.py`'s peaks and
`bound`).

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power
limit; a card set lower runs slower, so every share is printed beside
the card's power limit.  A 16 x 16-bit limb product is 4 int8 sub-digit
multiply-accumulates, 8 int8 operations.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1979e12          # int8 tensor-core operations per second
PEAK_BYTES = 3.35e12             # HBM3 bytes per second
OPS_PER_LIMB_PRODUCT = 8


def bound(products: int, nbytes: int) -> tuple[float, str]:
    """(seconds, "operations" or "bytes"): the least time the card could
    take for `products` limb products that move `nbytes`, the larger of
    the two times, and which of them sets it."""
    ops = OPS_PER_LIMB_PRODUCT * products / PEAK_INT8_OPS
    mem = nbytes / PEAK_BYTES
    return max(ops, mem), "operations" if ops >= mem else "bytes"
