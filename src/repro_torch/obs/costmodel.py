"""The paper's cost model for the port: kernel launches of a batched
division, a Barrett reduction and a modexp ladder.  A jax-free copy of
the parts of `repro/obs/costmodel.py` the port runs (that module lazily
imports the JAX `core/shinv.py` for `refine_iters`, so the port keeps
its own).  The port has one kernel path, the JAX package's
impl="pallas_fused" one, so nothing here takes an `impl`."""

from __future__ import annotations

import math

FUSED_STEP_LAUNCHES = 2        # powdiff launch + update launch
FUSED_CORRECT_LAUNCHES = 1     # divmod finalization
FUSED_BARRETT_LAUNCHES = 1     # Barrett reduction core
MUL_LAUNCHES = 1               # one batched full product


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


def precompute_iters(m_limbs: int) -> int:
    """Refine trip count of the Barrett precompute of an m-limb modulus:
    h = 2m + 2 and h - k <= h - 1 bound the refinement length
    (`repro/core/modarith.py:113-117`)."""
    return math.ceil(math.log2(max(2 * m_limbs + 1, 2))) + 2


def precompute_launches(m_limbs: int) -> int:
    """Kernel launches of one Barrett precompute (a shinv, no
    finalization): 30/32/34 at m = 2048/4096/8192."""
    return FUSED_STEP_LAUNCHES * precompute_iters(m_limbs)


def barrett_launches() -> int:
    """Kernel launches of one batched Barrett reduction."""
    return FUSED_BARRETT_LAUNCHES


def modmul_launches() -> int:
    """One modular multiplication: full product + Barrett reduction."""
    return MUL_LAUNCHES + barrett_launches()


def modexp_ladder(e_bits: int, window_bits: int = 4) -> dict:
    """Trip counts of the fixed-window modexp ladder
    (`core/modarith.py:modexp`) for an e_bits-bit exponent storage:
    n_windows windows of window_bits squarings + 1 table multiply,
    plus the 2^window_bits-entry table build and the two initial
    reductions (a mod v, 1 mod v).  All counts are static: the ladder
    is data-independent by construction."""
    if e_bits % window_bits:
        raise ValueError("window_bits must divide the exponent width")
    n_win = e_bits // window_bits
    squarings = n_win * window_bits
    table_muls = 1 << window_bits
    window_muls = n_win
    modmuls = squarings + table_muls + window_muls
    return {
        "n_windows": n_win,
        "squarings": squarings,
        "table_muls": table_muls,
        "window_muls": window_muls,
        "modmuls": modmuls,
        "reductions": modmuls + 2,       # + a mod v, 1 mod v
    }


def modexp_launches(e_bits: int, window_bits: int = 4) -> int:
    """Kernel launches of one batched modexp: 674 for a 256-bit
    exponent at window 4."""
    lad = modexp_ladder(e_bits, window_bits)
    return lad["modmuls"] * modmul_launches() + 2 * barrett_launches()
