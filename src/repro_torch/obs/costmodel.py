"""The paper's cost model for the port: kernel launches of a batched
division, a Barrett precompute, a reduction and a modexp ladder, per
impl.  A jax-free copy of the parts of `repro/obs/costmodel.py` the port
runs (that module lazily imports the JAX `core/shinv.py` for
`refine_iters`, so the port keeps its own), with the impl names of
`kernels/ops.py`: cuda_fused (JAX pallas_fused), cuda_batched
(pallas_batched), cuda_pairs (pallas) and blocked.  A launch is one
kernel of this package; the blocked impl launches none.  Every count
defaults to cuda_fused."""

from __future__ import annotations

import math

FUSED_STEP_LAUNCHES = 2        # powdiff launch + update launch
FUSED_CORRECT_LAUNCHES = 1     # divmod finalization
FUSED_BARRETT_LAUNCHES = 1     # Barrett reduction core
MUL_LAUNCHES = 1               # one batched full product
# Full-width torch ops in the unfused step composition (the JAX
# package's count of its XLA glue ops, `repro/obs/costmodel.py`).
UNFUSED_STEP_GLUE_OPS = 19
# Unfused product launches per Refine iteration (PowDiff and w*x).
UNFUSED_STEP_MUL_LAUNCHES = 2
KERNEL_PRODUCTS = ("cuda_pairs", "cuda_batched", "cuda_fused")


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


def step_launches(impl: str = "cuda_fused") -> int:
    """Kernel launches of one Refine iteration under `impl`."""
    if impl == "cuda_fused":
        return FUSED_STEP_LAUNCHES
    return UNFUSED_STEP_MUL_LAUNCHES if impl in KERNEL_PRODUCTS else 0


def step_glue_ops(impl: str = "cuda_fused") -> int:
    """Full-width torch glue ops per Refine iteration under `impl`."""
    return 0 if impl == "cuda_fused" else UNFUSED_STEP_GLUE_OPS


def mul_launches(impl: str = "cuda_fused") -> int:
    """Kernel launches of one batched full product under `impl`."""
    return MUL_LAUNCHES if impl in KERNEL_PRODUCTS else 0


def divmod_launches(m_limbs: int, impl: str = "cuda_fused") -> int:
    """Kernel launches of one batched divmod at M limbs: under
    cuda_fused two per Refine iteration plus one finalization; under an
    unfused kernel impl two products per iteration plus the
    finalization's two (u * shinv, v * q)."""
    it = refine_iters(m_limbs)
    if impl == "cuda_fused":
        return FUSED_STEP_LAUNCHES * it + FUSED_CORRECT_LAUNCHES
    return step_launches(impl) * it + 2 * mul_launches(impl)


def precompute_iters(m_limbs: int) -> int:
    """Refine trip count of the Barrett precompute of an m-limb modulus:
    h = 2m + 2 and h - k <= h - 1 bound the refinement length
    (`repro/core/modarith.py:113-117`)."""
    return math.ceil(math.log2(max(2 * m_limbs + 1, 2))) + 2


def precompute_launches(m_limbs: int, impl: str = "cuda_fused") -> int:
    """Kernel launches of one Barrett precompute (a shinv, no
    finalization): 30/32/34 at m = 2048/4096/8192 under cuda_fused, and
    as many under cuda_batched and cuda_pairs (two products per
    iteration)."""
    return step_launches(impl) * precompute_iters(m_limbs)


def barrett_launches(impl: str = "cuda_fused") -> int:
    """Kernel launches of one batched Barrett reduction: one fused
    launch, or the two truncated products unfused."""
    if impl == "cuda_fused":
        return FUSED_BARRETT_LAUNCHES
    return 2 * mul_launches(impl)


def modmul_launches(impl: str = "cuda_fused") -> int:
    """One modular multiplication: full product + Barrett reduction."""
    return mul_launches(impl) + barrett_launches(impl)


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


def modexp_launches(e_bits: int, window_bits: int = 4,
                    impl: str = "cuda_fused") -> int:
    """Kernel launches of one batched modexp: 674 for a 256-bit
    exponent at window 4 under cuda_fused."""
    lad = modexp_ladder(e_bits, window_bits)
    return (lad["modmuls"] * modmul_launches(impl)
            + 2 * barrett_launches(impl))


def model_launches(op: str, m_limbs: int, impl: str = "cuda_fused",
                   e_bits: int | None = None,
                   window_bits: int = 4) -> int | None:
    """Kernel launches of one service op on one bucket at m limbs:
    divmod, precompute, reduce, modmul, and modexp when e_bits is given
    (the JAX package returns None for modexp, whose launches sit in scan
    bodies; the port counts them at run time).  None for anything
    else."""
    if op == "divmod":
        return divmod_launches(m_limbs, impl)
    if op == "precompute":
        return precompute_launches(m_limbs, impl)
    if op == "reduce":
        return barrett_launches(impl)
    if op == "modmul":
        return modmul_launches(impl)
    if op == "modexp" and e_bits is not None:
        return modexp_launches(e_bits, window_bits, impl)
    return None
