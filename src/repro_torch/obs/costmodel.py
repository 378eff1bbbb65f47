"""The paper's cost model for the port: kernel launches of a batched
division.  A jax-free copy of the parts of `repro/obs/costmodel.py`
the division slice needs (that module lazily imports the JAX
`core/shinv.py` for `refine_iters`, so the port keeps its own)."""

from __future__ import annotations

import math

FUSED_STEP_LAUNCHES = 2        # powdiff launch + update launch
FUSED_CORRECT_LAUNCHES = 1     # divmod finalization


def refine_iters(m_limbs: int) -> int:
    """Static Refine trip count ceil(log2(M)) + 2 for an M-limb
    division (the paper's Algorithm 1 line 19; `repro/core/shinv.py:74`)."""
    return math.ceil(math.log2(max(m_limbs, 2))) + 2


def refine_window(i: int, width: int, windowed: bool = True) -> int:
    """Static operand window (limbs) of Refine iteration i at working
    width `width`: iteration i satisfies l <= 2^i + 1, so its operands
    fit 2^(i+1) + 16 limbs."""
    if not windowed:
        return width
    return min(max(32, 2 ** (i + 1) + 16), width)


def divmod_launches(m_limbs: int) -> int:
    """Kernel launches of one batched divmod at M limbs: two per Refine
    iteration plus one finalization."""
    return (FUSED_STEP_LAUNCHES * refine_iters(m_limbs)
            + FUSED_CORRECT_LAUNCHES)
