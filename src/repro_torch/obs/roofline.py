"""Roofline terms of the port's work on one NVIDIA H100 SXM: the port's
counterpart of `repro/utils/hlo_costs.py:roofline_terms`.

The JAX package reads its operations and bytes off the compiled XLA
program; here they come from the paper's cost model in multiplications
(`obs/costmodel.py`: limb products and bytes per kernel launch), since
the port's work is hand-written kernels whose products the model counts
exactly.  A 16 x 16-bit limb product is 4 int8 sub-digit
multiply-accumulates on the tensor cores, 8 int8 operations.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power
limit (a card set lower runs slower: state its limit beside any share).
"""

from __future__ import annotations

PEAK_INT8_OPS = 1979e12          # int8 tensor-core operations per second
PEAK_BF16_FLOPS = 989e12         # bf16 tensor-core FLOP/s (the LM path)
PEAK_BYTES = 3.35e12             # HBM3 bytes per second
OPS_PER_LIMB_PRODUCT = 8


def bound(products: int, nbytes: int) -> tuple[float, str]:
    """(seconds, "operations" or "bytes"): the least time the card could
    take for `products` limb products that move `nbytes`, the larger of
    the two times, and which of them sets it."""
    ops = OPS_PER_LIMB_PRODUCT * products / PEAK_INT8_OPS
    mem = nbytes / PEAK_BYTES
    return max(ops, mem), "operations" if ops >= mem else "bytes"


def flop_bound(flops: float, nbytes: int) -> tuple[float, str]:
    """(seconds, "operations" or "bytes") for `flops` bf16 tensor-core
    FLOPs that move `nbytes`: the LM path's bound."""
    ops = flops / PEAK_BF16_FLOPS
    mem = nbytes / PEAK_BYTES
    return max(ops, mem), "operations" if ops >= mem else "bytes"


def roofline_terms(work) -> dict:
    """The roofline of a sequence of launches, [(kernel, products,
    bytes)] (`costmodel.divmod_work` & co.): `compute_s` and `memory_s`
    summed over the launches, `collective_s` 0 (batch sharding
    exchanges nothing between shards), `dot_flops` the int8 operations,
    `bytes`, `wire_bytes` 0 and the `bottleneck`, with the keys of the
    JAX package's `roofline_terms`."""
    products = sum(w[1] for w in work)
    nbytes = sum(w[2] for w in work)
    compute_s = OPS_PER_LIMB_PRODUCT * products / PEAK_INT8_OPS
    memory_s = nbytes / PEAK_BYTES
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": 0.0,
        "dot_flops": float(OPS_PER_LIMB_PRODUCT * products),
        "bytes": float(nbytes),
        "wire_bytes": 0.0,
        "bottleneck": "compute" if compute_s >= memory_s else "memory",
    }
