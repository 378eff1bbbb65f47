"""The work the remainder tree's squares need, in limb products and bytes.

A level squares each node X (M/4 limbs) into its divisor X^2 (M/2
limbs) with the port's batched product.  The least work of a square
at the lane's own prec(X) = p is its p(p + 1)/2 distinct limb products
x_i x_j, i <= j: each cross term appears twice in X^2 and is formed
once (the paper's a * b count of a general product, `costmodel.py`,
would count p^2 and so nearly halve the least time's share).  Bytes:
X read once and X^2 written once, as int32 at the level's widths (the
layout the benchmark hands the program).
"""

from __future__ import annotations

from collections import Counter

from bench.yardstick.costmodel import LIMB_BYTES


def square_lane_products(p: int) -> int:
    """Distinct limb products of one p-limb square: x_i x_j, i <= j."""
    return p * (p + 1) // 2


def squares_needed(lengths, m_limbs: int) -> tuple[int, int]:
    """(products, bytes) a level of squares needs: lengths holds prec(X)
    per node; X at m_limbs / 4 limbs, X^2 written at m_limbs / 2."""
    counts = Counter(lengths)
    products = sum(c * square_lane_products(p) for p, c in counts.items())
    per_lane = LIMB_BYTES * (m_limbs // 4 + m_limbs // 2)
    return products, per_lane * sum(counts.values())
