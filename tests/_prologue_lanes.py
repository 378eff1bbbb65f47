"""Edge lanes of a division's set-up (`core/shinv.py:prologue_plain` and
its kernel, `kernels/fused.py:prologue_cuda`), shared by the CPU tests
and the card tests.  Plain Python: no JAX, no torch."""

from __future__ import annotations

import random

B = 1 << 16


def _rand(rnd: random.Random, prec: int) -> int:
    """A random int of exactly `prec` limbs (0 for prec 0)."""
    if prec <= 0:
        return 0
    return rnd.randrange(B ** (prec - 1), B ** prec)


def divmod_lanes(m: int, seed: int = 0) -> list[tuple[int, int]]:
    """(u, v) pairs of m limbs: v = 0, 1, single limbs, B^k, B^h / 2 (so
    2v = B^h, h = prec(u)) and its neighbours, B^h and above, a top limb
    0xFFFF, a top bit that 2v carries out of v's width, u = 0 (h = 0),
    all-0xFFFF operands and random ones."""
    rnd = random.Random(seed)
    top = B ** m - 1
    h = max(2, m // 2)                 # prec(u) of the B^h lanes
    uh = _rand(rnd, h)
    full = _rand(rnd, m)
    lanes = [(full, 0), (full, 1), (full, 0xFFFF), (full, 12345),
             (full, 0x8000), (full, B), (full, B ** (m // 3 or 1)),
             (uh, B ** h // 2), (uh, B ** h // 2 + 1),
             (uh, B ** h // 2 - 1), (uh, B ** h - 1),
             (0, _rand(rnd, m // 2 or 1)), (0, 0), (0, 1), (0, B),
             (full, (0xFFFF << 16 * (m - 1)) + _rand(rnd, m - 1)),
             (full, 1 << (16 * m - 1)), (full, (1 << (16 * m - 1)) + 1),
             (top, top), (top, 2), (1, 1), (1, top), (B ** (m - 1), B),
             (uh, B ** (h - 1)), (uh, 3 * B ** (h - 1))]
    if h + 1 <= m:
        lanes += [(uh, B ** h), (uh, B ** h + 1), (uh, 2 * B ** h)]
    while len(lanes) < 37:             # not a multiple of any block size
        lanes.append((_rand(rnd, rnd.randint(1, m)),
                      _rand(rnd, rnd.randint(1, m))))
    return lanes


def shinv_lanes(width: int, seed: int = 0) -> list[tuple[int, int]]:
    """(v, h) pairs for the entry with a given h and v already `width`
    limbs wide: h = 0, in range, at and past the width's edge, and
    negative; v as in `divmod_lanes`, with top bits at the width's edge
    (2v mod B^width drops them)."""
    rnd = random.Random(seed)
    hs = [0, 1, 2, width // 2, width - 1, width, width + 3, -1]
    vs = [0, 1, 0xFFFF, 0x8000, B, B ** 2, _rand(rnd, width // 2),
          1 << (16 * width - 1), B ** width - 1, (1 << (16 * width - 1)) + 7,
          _rand(rnd, width)]
    lanes = []
    for h in hs:
        for v in vs:
            lanes.append((v, h))
        lanes += [(B ** h // 2, h), (B ** h // 2 + 1, h),
                  (B ** h // 2 - 1, h), (B ** h, h), (B ** h + 1, h)] \
            if 1 <= h < width else []
    return [(v % B ** width, h) for v, h in lanes]
