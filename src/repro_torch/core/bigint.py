"""Multi-precision integer representation for PyTorch.

A big integer is a fixed-width little-endian vector of base-2^16 digits
("limbs").  Inside the port limbs are stored as int32 (each value
< 2^16): torch's uint32 has no `+`, `>>`, `<` or `//`, and int32 leaves
headroom for the sums and borrows the arithmetic forms without the
wrap-around tricks of the JAX package's uint32 storage.

The JAX package (`repro.core.bigint`) keeps uint32 limbs; the two meet
only at the boundary, through `limbs_from_numpy` / `limbs_to_numpy`, so
both packages see exactly the same bits.  Host conversions here are
NumPy/Python only.
"""

from __future__ import annotations

import numpy as np
import torch

LOG_BASE = 16                  # bits per digit
BASE = 1 << LOG_BASE           # digit base B = 65536
MASK = BASE - 1
DTYPE = torch.int32            # storage dtype (value of each limb < B)


def width_for_bits(bits: int) -> int:
    """Number of limbs for an integer precision in bits."""
    return -(-bits // LOG_BASE)


def from_int(x: int, m: int) -> np.ndarray:
    """Python int -> little-endian uint32 limb vector of length m (host)."""
    if x < 0:
        raise ValueError("unsigned representation only")
    nbytes = 2 * m
    if x.bit_length() > 8 * nbytes:
        raise OverflowError("value does not fit in m limbs")
    raw = np.frombuffer(x.to_bytes(nbytes, "little"), dtype="<u2")
    return raw.astype(np.uint32)


def to_int(limbs) -> int:
    """Limb vector -> Python int (host)."""
    a = np.asarray(limbs)
    if a.size and (a.min() < 0 or a.max() > MASK):
        raise ValueError("limb outside [0, B)")
    return int.from_bytes(a.astype("<u2").tobytes(), "little")


def batch_from_ints(xs, m: int) -> np.ndarray:
    """(len(xs), m) uint32 limbs -- the layout of the JAX package's
    `bigint.batch_from_ints`, which `limbs_from_numpy` takes."""
    if not len(xs):
        return np.zeros((0, m), np.uint32)
    return np.stack([from_int(x, m) for x in xs])


def batch_to_ints(arr) -> list[int]:
    if isinstance(arr, torch.Tensor):
        arr = limbs_to_numpy(arr)
    return [to_int(row) for row in np.asarray(arr)]


def random_ints(rng: np.random.Generator, n: int, digits: int,
                exact_prec: bool = False) -> list[int]:
    """n random ints with <= `digits` base-B digits (>= if exact_prec).
    Same draws as the JAX package's `bigint.random_ints` for one rng."""
    out = []
    for _ in range(n):
        d = digits if exact_prec else int(rng.integers(1, digits + 1))
        lo = BASE ** (d - 1) if exact_prec else 0
        hi = BASE ** d
        out.append(int(rng.integers(lo, hi, dtype=np.uint64)) if hi <= 2**64
                   else _rand_big(rng, lo, hi))
    return out


def _rand_big(rng: np.random.Generator, lo: int, hi: int) -> int:
    span = hi - lo
    nb = span.bit_length()
    while True:
        x = 0
        for _ in range(-(-nb // 32)):
            x = (x << 32) | int(rng.integers(0, 1 << 32, dtype=np.uint64))
        x &= (1 << nb) - 1
        if x < span:
            return lo + x


def limbs_from_numpy(a, device) -> torch.Tensor:
    """uint32 limb array (values < B) -> int32 limb tensor on `device`."""
    a = np.asarray(a)
    if a.size and int(a.max()) > MASK:
        raise ValueError("limb outside [0, B)")
    return torch.from_numpy(a.astype(np.int32)).to(device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array on the host."""
    return t.detach().to("cpu").numpy().astype(np.uint32)


def one_hot_pow(p: torch.Tensor, m: int) -> torch.Tensor:
    """B^p as (batch, m) limbs (0 where p >= m); p is a (batch,) tensor."""
    idx = torch.arange(m, dtype=DTYPE, device=p.device)
    return (idx == p[:, None]).to(DTYPE)
