"""Multiplication entry points and the fused division-step and Barrett
dispatch.

The dispatch rule is the device of the operands: a CPU tensor goes to
the plain PyTorch version, a CUDA tensor to the hand-written Hopper
kernel (kernels/bigmul.py, kernels/fused.py), and any other device
raises.  There is no fallback from a kernel to its plain version.

`mul_plain` is the plain product.  It is exact on both devices: limbs
are base 2^16, so one limb product is < 2^32 and a column sum of a
product of W-limb operands is < W * (2^16 - 1)^2 < 2^46 for
W <= 16392 (the 2^18-bit working width), far inside float64's 2^53
exact-integer range.  CUDA has no integer matrix product, so the
column sums come from float64 block-Toeplitz products (exact, since
every partial sum is an integer < 2^53); carries are resolved in int64
exactly as the kernels resolve them (`csrc/limbs.cuh:resolve`).
"""

from __future__ import annotations

import torch

from repro_torch.core import arith as A
from repro_torch.core.bigint import DTYPE, LOG_BASE, MASK

# Limbs per Toeplitz tile of the plain product.
BLOCK_T = 128


def _check_device(*ts: torch.Tensor) -> str:
    dev = ts[0].device.type
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("operands lie on different devices")
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no implementation for device {dev!r}")
    return dev


def resolve_columns(col: torch.Tensor) -> torch.Tensor:
    """Exact column sums (batch, n) int64, each < 2^48 -> canonical
    base-2^16 limbs (batch, n) int32, mod B^n.

    Each sum is split into three 16-bit pieces added at offsets 0, 1
    and 2 limbs (< 3 * 2^16), one local pass leaves digits <= 2^16 + 1
    with carries in {0, 1}, and one generate/propagate scan finishes."""
    col = col.to(torch.int64)
    e = ((col & MASK) + A.shift((col >> LOG_BASE) & MASK, 1)
         + A.shift(col >> (2 * LOG_BASE), 2))
    f = (e & MASK) + A.shift(e >> LOG_BASE, 1)
    c = A.carry_scan((f >> LOG_BASE).to(DTYPE), (f == MASK).to(DTYPE))
    return ((f + c) & MASK).to(DTYPE)


def mul_plain(u: torch.Tensor, v: torch.Tensor, out_width: int) -> torch.Tensor:
    """Exact (u * v) mod B^out_width for (batch, Wu) x (batch, Wv) limb
    tensors, on either device, in plain PyTorch."""
    t = BLOCK_T
    batch = u.shape[0]
    u = u[:, :out_width]                      # limbs >= out_width can't matter
    v = v[:, :out_width]
    nu = max(-(-u.shape[1] // t), 1)
    nv = max(-(-v.shape[1] // t), 1)
    f64 = torch.float64
    uf = torch.nn.functional.pad(u.to(f64), (0, nu * t - u.shape[1]))
    uf = uf.reshape(batch, nu, t)
    vg = torch.nn.functional.pad(v.to(f64), (t, nv * t - v.shape[1] + t))
    # toep[b, j, c, s] = v[j*t + s - c] for 0 <= s - c < t, else 0
    dev = u.device
    j = torch.arange(nv, device=dev)[:, None, None]
    c = torch.arange(t, device=dev)[None, :, None]
    s = torch.arange(2 * t, device=dev)[None, None, :]
    toep = vg[:, j * t + s - c + t]
    toep = toep * ((s - c >= 0) & (s - c < t)).to(f64)
    raw = torch.zeros(batch, (nu + nv + 1) * t, dtype=f64, device=dev)
    for i in range(nu):
        if i * t >= out_width:
            break
        prods = torch.einsum("bc,bjcs->bjs", uf[:, i], toep)   # (b, nv, 2t)
        raw[:, i * t:(i + nv) * t] += prods[..., :t].reshape(batch, -1)
        raw[:, (i + 1) * t:(i + 1 + nv) * t] += prods[..., t:].reshape(
            batch, -1)
    col = raw.to(torch.int64)[:, :out_width]
    if col.shape[1] < out_width:
        col = torch.nn.functional.pad(col, (0, out_width - col.shape[1]))
    return resolve_columns(col)


def mul_batch(u: torch.Tensor, v: torch.Tensor, out_width: int) -> torch.Tensor:
    """Batched exact product: (batch, Wu) x (batch, Wv) -> (batch,
    out_width) limbs, mod B^out_width."""
    if _check_device(u, v) == "cuda":
        from . import bigmul
        return bigmul.mul_batch_cuda(u, v, out_width)
    return mul_plain(u, v, out_width)


def mul(u: torch.Tensor, v: torch.Tensor, out_width: int) -> torch.Tensor:
    """Exact u * v truncated to out_width limbs for one (W,) instance."""
    return mul_batch(u[None], v[None], out_width)[0]


def mulmod(u: torch.Tensor, v: torch.Tensor, L, out_width: int) -> torch.Tensor:
    """(u * v) mod B^L per row, with L an int or a (batch,) tensor."""
    return A.mask_below(mul_batch(u, v, out_width), L)


def fused_step(v, w, *, h, m, l, s, active, g: int, win: int):
    """One guarded Refine iteration on the full-width iterate.

    v, w: (batch, W) limbs; h, m, l, s: (batch,) int32; active:
    (batch,) bool; g the guard digit count, win this iteration's static
    window.  Two kernel launches on CUDA (powdiff, update), the plain
    composition on the CPU."""
    from . import fused
    if _check_device(v, w) == "cuda":
        return fused.step_cuda(v, w, h=h, m=m, l=l, s=s, active=active,
                               g=g, win=win)
    return fused.step_reference(v, w, h=h, m=m, l=l, s=s, active=active,
                                g=g, win=win)


def fused_correct(u, v, si, *, h):
    """divmod finalization -> (q, r) at width W, with divmod(u, 0) =
    (0, u).  One kernel launch on CUDA, the plain composition on the
    CPU."""
    from . import fused
    if _check_device(u, v, si) == "cuda":
        return fused.correct_cuda(u, v, si, h=h)
    return fused.correct_reference(u, v, si, h=h)


def fused_barrett(x, mu, v, *, h: int):
    """Barrett reduction core -> r at width W (the caller cuts it to the
    modulus width).  x: (batch, <= W) limbs; mu: (W,) shared or
    (batch, W) per lane; v likewise, at most W limbs; h a static int.
    One kernel launch on CUDA, the plain composition on the CPU."""
    from . import fused
    if _check_device(x, mu, v) == "cuda":
        return fused.barrett_cuda(x, mu, v, h=h)
    return fused.barrett_reference(x, mu, v, h=h)
