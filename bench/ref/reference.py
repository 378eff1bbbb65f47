"""Plain Python-int reference for the benchmark's cells, and the
control that must fail its comparison.

The harness hands these functions the ints it made from `--seed` and the
program's answers as NumPy limb arrays; everything else (quotients and
remainders) is worked out here.  Only the
standard library and NumPy are imported.
"""

from __future__ import annotations

import numpy as np

LOG_BASE = 16
BASE = 1 << LOG_BASE


def prec(x: int) -> int:
    """Significant base-2^16 limbs of x (prec(0) = 0)."""
    return -(-x.bit_length() // LOG_BASE)


def ints_from_limbs(arr) -> list[int]:
    """(n, m) little-endian base-2^16 limbs (any integer dtype, each
    value in [0, 2^16)) -> n Python ints."""
    a = np.asarray(arr)
    if a.size and (a.min() < 0 or a.max() >= BASE):
        raise ValueError("limb outside [0, 2^16)")
    rows = np.ascontiguousarray(a.astype("<u2"))
    return [int.from_bytes(r.tobytes(), "little") for r in rows]


def limbs_from_ints(xs, m: int) -> np.ndarray:
    """n Python ints -> (n, m) int32 limbs."""
    out = np.zeros((len(xs), m), np.int32)
    for i, x in enumerate(xs):
        out[i] = np.frombuffer(x.to_bytes(2 * m, "little"), "<u2")
    return out


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def divmod_ref(u: int, v: int) -> tuple[int, int]:
    """(q, r) with u = q v + r, 0 <= r < v; divmod(u, 0) = (0, u)."""
    return divmod(u, v) if v else (0, u)


def wrong_divisions(us, vs, qs, rs) -> int:
    """Lanes whose (q, r) differ from divmod_ref."""
    return sum((q, r) != divmod_ref(u, v)
               for u, v, q, r in zip(us, vs, qs, rs, strict=True))


# ---------------------------------------------------------------------------
# the control: the reference in the program's place with one stated
# guarantee broken (the step a later change could be tempted to drop)
# ---------------------------------------------------------------------------

def divmod_uncorrected(u: int, v: int) -> tuple[int, int]:
    """The division without its final correction: q = floor(u
    floor(B^h / v) / B^h) at h = prec(u), r = u - q v, as the shifted
    inverse gives them before the delta in {-1, 0, +1} is applied."""
    if v == 0:
        return 0, u
    h = prec(u)
    q = (u * (BASE ** h // v)) >> (LOG_BASE * h)
    return q, u - q * v
