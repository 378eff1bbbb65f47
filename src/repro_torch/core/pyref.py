"""Pure-Python (exact int) reference of the whole-shifted-inverse division.

The port's copy of `repro/core/pyref.py` (the port imports nothing of
the JAX package): Algorithms 1 (Shinv), 2 (PowDiff) and 3 (Div) of the
paper, executed on Python's arbitrary precision integers.  It exists
for three reasons:

  1. Ground truth for the PyTorch / CUDA implementations (bit-exact
     compare).
  2. Cost-model instrumentation: every multi-precision multiplication is
     recorded with its operand/result sizes so the paper's "5 to 7 full
     multiplications" claim (Sec. 2.3) can be validated empirically.
  3. Executable documentation of the algorithm revisions (Theorem 2
     sign handling, quotient correction with delta in {-1, 0, +1}).

The implementation keeps the paper's structure: special cases, two-digit
initial approximation, Refine with guard digits / shorter iterates /
divisor prefixes, Step with explicit sign handling, PowDiff with the
close-product (MULTMOD) path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# Cost-model instrumentation
# ---------------------------------------------------------------------------

@dataclass
class MultRecord:
    """One multi-precision multiplication event."""
    prec_a: int      # digits of left operand
    prec_b: int      # digits of right operand
    prec_out: int    # digits of the computed result (L for MULTMOD)
    kind: str        # "mult" | "multmod"
    where: str       # call-site tag


@dataclass
class CostCounter:
    """Counts multiplications in units of 'full multiplications'.

    Following Sec 2.3 of the paper, a *full* multiplication (for total
    operand size M) is one whose computed result exceeds M/2 digits.
    ``full_mults(M)`` converts the record list to the paper's unit,
    where a classical product costs (prec_a * prec_b) digit-mults and a
    full MxM product costs M*M of them.
    """
    records: list[MultRecord] = field(default_factory=list)

    def record(self, a: int, b: int, out_prec: int, kind: str, where: str,
               base: int) -> None:
        self.records.append(
            MultRecord(prec(a, base), prec(b, base), out_prec, kind, where))

    def digit_mults(self) -> int:
        """Total classical digit-multiplications performed."""
        total = 0
        for r in self.records:
            if r.kind == "multmod":
                # classical low-L product: sum_{i<L} min(i+1, prec_a, prec_b)
                # approximated as the triangular count
                a, b, L = r.prec_a, r.prec_b, r.prec_out
                total += sum(min(i + 1, a, b) for i in range(L))
            else:
                total += r.prec_a * r.prec_b
        return total

    def full_mult_equivalents(self, M: int) -> float:
        """Work expressed in units of one full MxM classical product."""
        return self.digit_mults() / float(M * M)

    def n_full_mults(self, M: int) -> int:
        """Number of mult events whose result exceeds M/2 digits ==
        the paper's count of 'full multiplications'."""
        return sum(1 for r in self.records if r.prec_out > M // 2)


# ---------------------------------------------------------------------------
# Digit helpers (base-B, little-endian semantics)
# ---------------------------------------------------------------------------

def prec(x: int, base: int) -> int:
    """Number of base-B digits of x (prec(0) == 0)."""
    if x == 0:
        return 0
    n = 0
    while x:
        x //= base
        n += 1
    return n


def digit(x: int, i: int, base: int) -> int:
    """i-th least-significant base-B digit of x."""
    return (x // base ** i) % base


def shift(x: int, n: int, base: int) -> int:
    """Whole shift: floor(x * B^n). n<0 drops low digits."""
    if n >= 0:
        return x * base ** n
    return x // base ** (-n)


def to_digits(x: int, m: int, base: int) -> list[int]:
    """Little-endian digit vector of fixed length m."""
    out = []
    for _ in range(m):
        x, d = divmod(x, base)
        out.append(d)
    if x:
        raise ValueError("value does not fit in m digits")
    return out


def from_digits(ds, base: int) -> int:
    x = 0
    for d in reversed(list(ds)):
        x = x * base + int(d)
    return x


# ---------------------------------------------------------------------------
# Algorithm 2: PowDiff -- |B^h - v*w| with sign, via close product
# ---------------------------------------------------------------------------

def powdiff(v: int, w: int, h: int, l: int, base: int,
            counter: CostCounter | None = None,
            check_invariant: bool = True) -> tuple[int, int]:
    """Returns (sign, |B^h - v*w|); sign==1 means B^h - v*w >= 0.

    Uses the close-product strategy: when the invariant guarantees the
    difference is small, only the low L digits of v*w are computed
    (MULTMOD) and the sign is recovered from the top digit of P.
    """
    L = prec(v, base) + prec(w, base) - l + 1
    full = (v == 0 or w == 0 or L >= h)
    if full:
        p = v * w
        if counter is not None:
            counter.record(v, w, prec(p, base), "mult", "powdiff-full", base)
        d = base ** h - p
        return (1, d) if d >= 0 else (0, -d)
    # close product: P = (v*w) mod B^L ; B^h mod B^L == 0 since h > L
    P = (v * w) % base ** L
    if counter is not None:
        counter.record(v, w, L, "multmod", "powdiff-close", base)
    if check_invariant:
        # Validity of sign recovery requires |B^h - v*w| < B^(L-1)-ish;
        # assert the weaker L-digit bound that the algorithm relies on.
        assert abs(base ** h - v * w) < base ** L, (
            "close-product invariant violated", v, w, h, l, L)
    if P == 0:
        return (1, 0)
    if digit(P, L - 1, base) == 0:   # P < B^(L-1): difference is negative
        return (0, P)
    return (1, base ** L - P)        # positive difference B^L - P


# ---------------------------------------------------------------------------
# Algorithm 1: Step -- one Newton iteration  (sign-aware, floor-correct)
# ---------------------------------------------------------------------------

def step(h: int, v: int, w: int, m: int, l: int, g: int, base: int,
         counter: CostCounter | None = None) -> int:
    """w' = shift_m(w) +/- shift_{2m-h}(w * |B^(h-m) - v*w|), floor-exact."""
    sign, x = powdiff(v, w, h - m, l - g, base, counter)
    tmp = w * x
    if counter is not None:
        counter.record(w, x, prec(tmp, base), "mult", "step-wx", base)
    shifted = shift(tmp, 2 * m - h, base)
    if sign:
        return shift(w, m, base) + shifted
    res = shift(w, m, base) - shifted
    # Floor correction: if any dropped digit of tmp was nonzero, the
    # negative term was truncated toward zero -> subtract one more.
    if 2 * m - h < 0 and tmp % base ** (h - 2 * m) != 0:
        res -= 1
    return res


# ---------------------------------------------------------------------------
# Algorithm 1: Refine -- guarded, shorter-iterates, divisor-prefix loop
# ---------------------------------------------------------------------------

def refine(v: int, h: int, k: int, w: int, l: int, base: int,
           counter: CostCounter | None = None) -> int:
    """Refine initial approx w (l correct digits, scale k+l) to shinv_h(v).

    Invariant maintained: w approximates B^(k+l+g)/v with ~l good digits.
    Each iteration gains m = min(h-k+1-l, l) digits and drops one
    (shorter iterates).  Divisor prefixes: only the top 2l+g digits of v
    participate (s = max(0, k-2l+1-g)).  Fixed trip count (JAX-friendly):
    ceil(log2(h-k-1)) + 2, with the l = h-k fixpoint absorbing extras.
    """
    g = 2
    w = shift(w, g, base)
    hk = h - k
    iters = (math.ceil(math.log2(hk - 1)) if hk - 1 >= 2 else 0) + 2
    for i in range(iters):
        m = min(hk + 1 - l, l)
        if m < 0:
            m = 0
        s = max(0, k - 2 * l + 1 - g)
        v_pre = shift(v, -s, base)
        w = step(k + l + m - s + g, v_pre, w, m, l, g, base, counter)
        w = shift(w, -1, base)
        l = l + m - 1
    # w ~ B^(k+l+g)/v ; land on scale h exactly.
    return shift(w, h - k - l - g, base)


# ---------------------------------------------------------------------------
# Algorithm 1: Shinv
# ---------------------------------------------------------------------------

def shinv(v: int, h: int, base: int,
          counter: CostCounter | None = None) -> int:
    """Whole shifted inverse: returns shinv_h(v) + lambda, lambda in {0,1}.

    (Theorem 2: with divisor prefixes the result may overestimate
    floor(B^h/v) by at most one; Div corrects for it.)
    """
    if v <= 0:
        raise ZeroDivisionError("shinv of non-positive divisor")
    # Group digits if the base is too small for the initial approximation.
    if base < 16:
        p = 2
        while base ** p < 16:
            p += 1
        hq = -(-h // p)                      # ceil(h / p)
        r = shinv(v, hq, base ** p, counter)
        return shift(r, h - p * hq, base)    # h - p*hq <= 0
    k = prec(v, base) - 1                    # B^k <= v < B^(k+1)
    # Special cases guarantee B < v <= B^h / 2.
    if v < base:
        return base ** h // v
    if prec(v, base) > h or (prec(v, base) == h and 2 * v > base ** h):
        # v > B^h -> 0 ; 2v > B^h -> 1   (exactness: v == B^h -> 1)
        if v > base ** h:
            return 0
        return 1
    if 2 * v > base ** h:
        return 1
    if v == base ** k:
        return base ** (h - k)
    # Initial approximation from the two most significant digits.
    V = digit(v, k - 1, base) + digit(v, k, base) * base
    w = base ** 3 // V
    return refine(v, h, k, w, 2, base, counter)


# ---------------------------------------------------------------------------
# Algorithm 3: Div -- quotient and remainder via shinv
# ---------------------------------------------------------------------------

def divmod_shinv(u: int, v: int, base: int,
                 counter: CostCounter | None = None) -> tuple[int, int]:
    """(q, r) with u = q*v + r, 0 <= r < v.  delta in {-1,0,+1} corrected."""
    if v == 0:
        raise ZeroDivisionError
    if u == 0:
        return (0, 0)
    h = prec(u, base)
    si = shinv(v, h, base, counter)
    p = u * si
    if counter is not None:
        # double-precision product (result shifted back by h): 2 fulls
        counter.record(u, si, prec(p, base), "mult", "div-u*shinv", base)
    q = shift(p, -h, base)
    m = v * q
    if counter is not None:
        counter.record(v, q, prec(m, base), "mult", "div-v*q", base)
    if u < m:                 # delta = -1 (shinv overestimated)
        q -= 1
        m -= v
    r = u - m
    if r >= v:                # delta = +1
        q += 1
        r -= v
    return (q, r)
