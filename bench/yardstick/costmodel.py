"""The work an operation needs, in limb products and bytes: a frozen
copy of the port's cost model (`repro_torch/obs/costmodel.py`, dense
forms) and, from it, the work of each lane at its own operand lengths.

Two forms:

- Dense (copied unchanged; `bench/test_bench_yardstick.py` holds them
  equal to the port's at the configurations' shapes): every operand at
  its full static window.  An upper bound on what any input needs.
- Needed (what the roofline shares divide by): the paper's algorithms
  at the lengths of each lane's own operands, counted as the paper's
  cost model counts a multiplication (`repro_torch/core/pyref.py`'s
  `CostCounter`: an a x b product is a * b limb products, a product
  cut to its low L limbs the products below limb L).  It takes the
  least of what the algorithm could need at those lengths, so a share
  never reads high because the count is: a product's operands are taken
  at the fewest limbs the algorithm's invariants allow.  Bytes: each
  input limb read once and each output limb written once, as int32 (the
  layout the benchmark hands the program).
"""

from __future__ import annotations

import math
from collections import Counter

PAD = 8
GUARD = 2                    # the Refine's guard digits g
LIMB_BYTES = 4


# ---------------------------------------------------------------------------
# dense forms (copied from repro_torch/obs/costmodel.py)
# ---------------------------------------------------------------------------

def refine_iters(m_limbs: int) -> int:
    """Static Refine trip count ceil(log2(M)) + 2 of an M-limb division."""
    return math.ceil(math.log2(max(m_limbs, 2))) + 2


def refine_window(i: int, width: int, windowed: bool = True) -> int:
    """Static operand window (limbs) of Refine iteration i."""
    if not windowed:
        return width
    return min(max(32, 2 ** (i + 1) + 16), width)


def div_width(m_limbs: int) -> int:
    return m_limbs + PAD


def cut_products(a: int, b: int, n: int) -> int:
    """Limb products i + j < n of an a-limb by a b-limb operand."""
    if not (a and b and n > 0):
        return 0
    a, b = min(a, b), max(a, b)
    full = max(0, min(a, n - b + 1))
    lo, hi = max(0, n - b + 1), min(a - 1, n - 1)
    tri = (hi - lo + 1) * n - (lo + hi) * (hi - lo + 1) // 2 \
        if hi >= lo else 0
    return full * b + tri


def powdiff_work(batch: int, full_w: int, win: int) -> tuple:
    """(products, bytes) of one dense powdiff launch."""
    return batch * win * win, 4 * batch * (2 * win + full_w + 4)


def update_work(batch: int, full_w: int, win: int) -> tuple:
    """(products, bytes) of one dense update launch."""
    n = min(2 * win, win + win, 2 * win)
    return (batch * cut_products(win, win, n),
            4 * (batch * (2 * win + full_w) + 4 * batch))


def correct_work(batch: int, width: int) -> tuple:
    """(products, bytes) of one dense correct launch."""
    W = width
    products = batch * (cut_products(W, W, min(2 * W, 2 * W, 2 * W))
                        + cut_products(W, W, W))
    return products, 4 * batch * (5 * W + 1)


def divmod_work(m_limbs: int, batch: int) -> list[tuple]:
    """[(kernel, products, bytes)] per launch of one dense cuda_fused
    divmod of (batch, M) limbs."""
    W = div_width(m_limbs)
    out = []
    for i in range(refine_iters(m_limbs)):
        win = refine_window(i, W)
        out += [("powdiff", *powdiff_work(batch, W, win)),
                ("update", *update_work(batch, W, win))]
    out.append(("correct", *correct_work(batch, W)))
    return out


# ---------------------------------------------------------------------------
# needed forms: the work of each lane at its own operand lengths
# ---------------------------------------------------------------------------

def prec(x: int) -> int:
    """Significant base-2^16 limbs of x (prec(0) = 0)."""
    return -(-x.bit_length() // 16)


def divmod_lane_products(nu: int, nv: int) -> int:
    """Limb products the paper's division (Algorithms 1-3,
    `repro_torch/core/pyref.py:divmod_shinv`) needs for a u of nu limbs
    by a v of nv limbs, from the lengths alone.  The Refine's scalars
    (l, m, s) follow from them exactly; the iterate w is taken at its
    fewest limbs l + g, the divisor prefix at k + 1 - s, the PowDiff
    difference at one limb under the prefix, shinv at h - k and q at
    h - k - 1 limbs.  The special cases (v = 0, one-limb v, v near or
    above B^h, v = B^k) need no product; v = B^k is not told apart by
    length and counts as a general divisor."""
    h, k = nu, nv - 1
    if nu == 0 or nv <= 1 or nv >= h:
        return 0
    g, hk, l = GUARD, h - k, 2
    iters = (math.ceil(math.log2(hk - 1)) if hk - 1 >= 2 else 0) + 2
    total = 0
    for _ in range(iters):
        m = max(0, min(hk + 1 - l, l))
        s = max(0, k - 2 * l + 1 - g)
        pv, pw = k + 1 - s, l + g
        top = k + l + g - s                 # PowDiff's power h' - m
        close = pv + pw - (l - g) + 1       # the close product's limbs
        total += pv * pw if close >= top else cut_products(pv, pw, close)
        total += pw * max(pv - 1, 0)        # w * |B^(h'-m) - v w|
        l = l + m - 1
    return total + h * (h - k) + (h - k - 1) * (k + 1)


def divmod_needed(lanes, m_limbs: int) -> tuple[int, int]:
    """(products, bytes) a batch of divisions needs: lanes (nu, nv) per
    lane; u and v read, q and r written at m_limbs limbs."""
    counts = Counter(lanes)
    products = sum(c * divmod_lane_products(nu, nv)
                   for (nu, nv), c in counts.items())
    return products, 4 * LIMB_BYTES * m_limbs * sum(counts.values())
