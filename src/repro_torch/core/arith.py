"""Linear-cost multi-precision primitives in PyTorch, batched.

Every function takes (batch, W) int32 limb tensors (base 2^16, values
< 2^16) and works on each row independently; the batch axis is written
out instead of vmapped.  Per-instance scalar arguments (shift amounts,
powers, lengths) are a Python int or a (batch,) int32 tensor on the
operands' device; predicates return (batch,) bool tensors.  Each
function mirrors its namesake in `repro.core.arith` at the same array
width, bit for bit.

torch has no associative scan, so the carry/borrow scan is the
Kogge-Stone ladder of log2(W) shifted combines (the form
`repro/kernels/fused.py:_k_scan` uses in-kernel).
"""

from __future__ import annotations

import torch

from .bigint import LOG_BASE, MASK, DTYPE


def _col(x, u: torch.Tensor):
    """A per-instance scalar as a (batch, 1) column (or a Python int)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=u.device, dtype=DTYPE).reshape(-1, 1)
    return int(x)


def _idx(u: torch.Tensor) -> torch.Tensor:
    return torch.arange(u.shape[-1], dtype=DTYPE, device=u.device)


def prec(u: torch.Tensor) -> torch.Tensor:
    """Number of significant limbs (0 for zero), (batch,) int32."""
    return torch.where(u != 0, _idx(u) + 1, 0).amax(dim=-1).to(DTYPE)


def shift(u: torch.Tensor, n) -> torch.Tensor:
    """Whole shift by n limbs (n > 0: times B^n, n < 0: floor-div by
    B^-n), truncated to the width.  |n| >= W gives zero."""
    w = u.shape[-1]
    if not isinstance(n, torch.Tensor):
        n = int(n)
        out = torch.zeros_like(u)
        if n >= 0 and n < w:
            out[..., n:] = u[..., :w - n]
        elif n < 0 and -n < w:
            out[..., :w + n] = u[..., -n:]
        return out
    src = _idx(u) - _col(n, u)
    ok = (src >= 0) & (src < w)
    got = torch.gather(u, -1, src.clamp(0, w - 1).to(torch.int64))
    return torch.where(ok, got, torch.zeros_like(u))


def carry_scan(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of (generate, propagate) carry pairs along the
    last axis -> carry INTO each position (identity element (0, 1))."""
    g, p = gen.to(DTYPE), prop.to(DTYPE)
    n = g.shape[-1]
    sft = 1
    while sft < n:
        gs = torch.nn.functional.pad(g[..., :n - sft], (sft, 0), value=0)
        ps = torch.nn.functional.pad(p[..., :n - sft], (sft, 0), value=1)
        g = g | (p & gs)
        p = p & ps
        sft <<= 1
    return torch.nn.functional.pad(g[..., :n - 1], (1, 0), value=0)


def add(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(u + v) mod B^W."""
    s = u + v
    c = carry_scan(s >> LOG_BASE, (s == MASK).to(DTYPE))
    return (s + c) & MASK


def _at0(u: torch.Tensor, d) -> torch.Tensor:
    inc = torch.zeros_like(u)
    inc[..., 0] = d if not isinstance(d, torch.Tensor) else d.to(DTYPE)
    return inc


def add_scalar(u: torch.Tensor, d) -> torch.Tensor:
    """u + d for a small scalar d (< B), int or (batch,) tensor."""
    return add(u, _at0(u, d))


def sub(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(u - v) mod B^W (exact when u >= v)."""
    b = carry_scan((u < v).to(DTYPE), (u == v).to(DTYPE))
    return (u - v - b) & MASK


def sub_scalar(u: torch.Tensor, d) -> torch.Tensor:
    return sub(u, _at0(u, d))


def sub_pow(u: torch.Tensor, p) -> torch.Tensor:
    """u - B^p by decrementing limbs [p, n], n the lowest nonzero limb
    index >= p (W when there is none)."""
    w = u.shape[-1]
    idx = _idx(u)
    p = _col(p, u)
    cand = (u != 0) & (idx >= p)
    n = torch.where(cand, idx, w).amin(dim=-1, keepdim=True)
    dec = (idx >= p) & (idx <= n)
    return torch.where(dec, (u - 1) & MASK, u)


def lt(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u < v per row: decided by the most significant differing limb."""
    top = torch.where(u != v, _idx(u) + 1, 0).amax(dim=-1)
    return (top > 0) & (take_limb(u, top - 1) < take_limb(v, top - 1))


def ge(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return ~lt(u, v)


def eq(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u == v).all(dim=-1)


def is_zero(u: torch.Tensor) -> torch.Tensor:
    return ~(u != 0).any(dim=-1)


def ge_pow(u: torch.Tensor, p) -> torch.Tensor:
    """u >= B^p  <=>  prec(u) > p."""
    p = _col(p, u)
    return prec(u) > (p.reshape(-1) if isinstance(p, torch.Tensor) else p)


def eq_pow(u: torch.Tensor, p) -> torch.Tensor:
    """u == B^p."""
    one = _idx(u) == _col(p, u)
    return torch.where(one, u == 1, u == 0).all(dim=-1)


def gt_pow(u: torch.Tensor, p) -> torch.Tensor:
    """u > B^p."""
    return ge_pow(u, p) & ~eq_pow(u, p)


def is_pow(u: torch.Tensor) -> torch.Tensor:
    """u == B^k for some k (a single nonzero limb, equal to 1)."""
    return ((u != 0).sum(dim=-1) == 1) & (u == 1).any(dim=-1)


def neg_mod_pow(u: torch.Tensor, L) -> torch.Tensor:
    """B^L - u for 0 < u < B^L: complement limbs below L, then +1."""
    comp = torch.where(_idx(u) < _col(L, u), MASK - u, 0)
    return add_scalar(comp, 1)


def mask_below(u: torch.Tensor, L) -> torch.Tensor:
    """u mod B^L."""
    return torch.where(_idx(u) < _col(L, u), u, 0)


def take_limb(u: torch.Tensor, i) -> torch.Tensor:
    """u[i] per row with i a (batch,) tensor or int (0 out of range)."""
    w = u.shape[-1]
    if not isinstance(i, torch.Tensor):
        i = torch.full((u.shape[0],), int(i), dtype=DTYPE, device=u.device)
    i = i.to(device=u.device, dtype=torch.int64).reshape(-1, 1)
    got = torch.gather(u, -1, i.clamp(0, w - 1)).reshape(-1)
    return torch.where((i.reshape(-1) >= 0) & (i.reshape(-1) < w), got, 0)


def ceil_log2(n) -> torch.Tensor:
    """ceil(log2(n)) for n >= 1 (int32, up to 2^30) in integer bit
    arithmetic: the number of k >= 0 with 2^k < n."""
    n = torch.as_tensor(n, dtype=DTYPE)
    out = torch.zeros_like(n)
    for k in range(31):
        out = out + ((1 << k) < n).to(DTYPE)
    return out
