"""Modular arithmetic on the cached whole shifted inverse (Barrett), in
PyTorch.

The batched counterpart of `repro/core/modarith.py`.  One Newton-iterated
shinv per modulus is the Barrett constant; after it every reduction is
two truncated products and two conditional subtracts in one kernel
launch (`kernels.ops.fused_barrett`):

  barrett_precompute(v) -> BarrettContext   one shinv, 2 * precompute_iters
                                            launches
  barrett_reduce(ctx, x)                    x mod v, 1 launch
  modmul(ctx, a, b)                         (a * b) mod v, 2 launches
  modexp(ctx, a, e)                         a^e mod v, fixed-window ladder

The batch axis is written out.  A context is shared (v (m,), mu (W,),
k ()) or per lane (v (batch, m), mu (batch, W), k (batch,)); every
function takes either, and the kernel reads a shared mu and v through a
row stride of 0.  As in the JAX package, h = 2m + MU_GUARD is fixed at
the modulus's storage width m, so any x < B^(2m) reduces in one pass,
and mu = shinv_h(v) + lambda (lambda in {0, 1}, exactly as
`shinv_batch` returns it) keeps the quotient estimate in {q-1, q, q+1}.

The modexp ladder has the JAX trip counts: 2^w table multiplies (the
last one's result is dropped, as `lax.scan` drops it), then per
MSB-first window w squarings and one multiply by the per-lane table
entry, so one modexp is `costmodel.modexp_launches(16 * e_limbs, w)`
launches whatever the data.

Every function takes `impl` (`kernels/ops.py`; None = cuda_fused).
Contract: v >= 1 (the service rejects v = 0 before it builds a
context); `barrett_reduce` raises ValueError for x wider than 2m limbs.
On the card, under cuda_fused and cuda_batched, whose kernels stage
their operands in shared memory at two bytes per limb, a modulus is
limited to the width whose operands fit (`check_width`, from the
kernel libraries): about 23,000 limbs under cuda_fused (the Barrett
kernel's x, mu and v) and 28,900 under cuda_batched, so 2^18-bit moduli
(16384 limbs) run under both; a wider one raises in
`barrett_precompute` before any launch.  cuda_pairs and blocked have no
such cap; nothing reroutes on its own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .bigint import DTYPE, LOG_BASE, limbs_from_numpy, one_hot_pow
from . import arith as A
from . import shinv as S
from repro_torch.kernels import digitmma as D, ops as K
from repro_torch.obs import costmodel as CM

# MU_GUARD (costmodel.MU_GUARD): guard digits above 2m in h (keeps the
# qhat error in {-1, 0, +1})
MU_GUARD = CM.MU_GUARD


def barrett_h(m: int) -> int:
    """Static shift h of the cached inverse for an m-limb modulus."""
    return 2 * m + MU_GUARD


def barrett_width(m: int) -> int:
    """Working width W of the reduction: holds B^h plus headroom."""
    return barrett_h(m) + S.PAD


class BarrettContext(NamedTuple):
    """Per-modulus state on the device: shared or per lane (see the
    module docstring)."""
    v: torch.Tensor      # modulus limbs, int32
    mu: torch.Tensor     # shinv_h(v) + lambda at width barrett_width(m)
    k: torch.Tensor      # prec(v), a diagnostic off the hot path

    @property
    def m(self) -> int:
        return self.v.shape[-1]

    @property
    def shared(self) -> bool:
        return self.v.ndim == 1


def context_from_numpy(v, mu, k, device) -> BarrettContext:
    """A JAX `BarrettContext`'s arrays (uint32 limbs, int32 k, as numpy)
    -> the port's context on `device`, so both packages reduce against
    the same mu."""
    return BarrettContext(
        v=limbs_from_numpy(v, device), mu=limbs_from_numpy(mu, device),
        k=torch.tensor(np.asarray(k, np.int32), device=device))


def check_width(device, m: int, impl: str | None = None) -> None:
    """Raise ValueError where impl's kernels cannot run an m-limb modulus
    on `device`, before any launch (`digitmma.check_staging`): on CUDA,
    cuda_fused stages the precompute's step kernels at the Barrett window
    W, the Barrett kernel and modmul's a * b, cuda_batched the product
    kernel at W x W -> 2W.  cuda_pairs, blocked and the CPU have no
    cap."""
    width = barrett_width(m)

    def need(libs, impl):
        if impl == "cuda_fused":   # precompute steps, reduce, modmul's a*b
            return max(libs["step"].step_smem_bytes(width),
                       libs["barrett"].barrett_smem_bytes(2 * m, m, width),
                       libs["mul"].mul_batch_smem_bytes(m, m, 2 * m))
        # every product is at most W x W -> 2W
        return libs["mul"].mul_batch_smem_bytes(width, width, 2 * width)

    D.check_staging(device, impl, width, f"a {m}-limb modulus", need)


def barrett_precompute(v: torch.Tensor, impl: str | None = None,
                       windowed: bool = True) -> BarrettContext:
    """One shinv at h = 2m + MU_GUARD: `costmodel.precompute_launches(m,
    impl)` launches on the card, with the size-bucketed Refine windows
    unless `windowed` is False (every iteration at the full width; the
    same mu).  v: (m,) for a shared context or (batch, m), v >= 1."""
    rows = v[None] if v.ndim == 1 else v
    m = rows.shape[-1]
    width, h = barrett_width(m), barrett_h(m)
    check_width(rows.device, m, impl)
    rows = rows.to(DTYPE)
    vw = torch.nn.functional.pad(rows, (0, width - m)).contiguous()
    hs = torch.full((rows.shape[0],), h, dtype=DTYPE, device=v.device)
    mu = S.shinv_batch(vw, hs, CM.precompute_iters(m), windowed=windowed,
                       impl=impl)
    k = A.prec(rows)
    if v.ndim == 1:
        return BarrettContext(v=rows[0], mu=mu[0], k=k[0])
    return BarrettContext(v=rows.contiguous(), mu=mu, k=k)


def barrett_reduce(ctx: BarrettContext, x: torch.Tensor,
                   impl: str | None = None) -> torch.Tensor:
    """x mod v for x (batch, <= 2m) limbs, any x < B^(2m): (batch, m)
    limbs, one launch.  x * mu < B^(2W) and q * v <= x + v < B^W, so
    neither truncation cuts anything the result needs."""
    m = ctx.m
    if x.shape[-1] > 2 * m:
        raise ValueError(f"x has {x.shape[-1]} limbs; reduce handles "
                         f"<= {2 * m}")
    r = K.fused_barrett(x.contiguous(), ctx.mu, ctx.v, h=barrett_h(m),
                        impl=impl)
    return r[:, :m]


def modmul(ctx: BarrettContext, a: torch.Tensor, b: torch.Tensor,
           impl: str | None = None) -> torch.Tensor:
    """(a * b) mod v for a, b (batch, m) limbs < B^m (not necessarily
    reduced): the full product, then one reduction."""
    return barrett_reduce(ctx, K.mul_batch(a, b, 2 * ctx.m, impl), impl)


def modexp(ctx: BarrettContext, a: torch.Tensor, e: torch.Tensor, *,
           window_bits: int = 4, impl: str | None = None) -> torch.Tensor:
    """a^e mod v by the fixed-window ladder with a constant trip count.

    a: (batch, <= m) limbs, e: (batch, e_limbs) limbs.  Every lane runs
    the same 16 * e_limbs / w windows of w squarings and one table
    multiply; leading zero windows multiply by table[0] = 1 mod v.  Each
    window's digit is read per lane from the exponent limbs on the
    device, and the table entry gathered per lane, so nothing is read
    back to the host."""
    if LOG_BASE % window_bits != 0:
        raise ValueError(f"window_bits must divide {LOG_BASE}")
    m, batch = ctx.m, a.shape[0]
    a_r = barrett_reduce(ctx, a, impl)
    zero = torch.zeros(batch, dtype=DTYPE, device=a.device)
    one_r = barrett_reduce(ctx, one_hot_pow(zero, m), impl)   # 1 mod v

    # table[i] = a^i mod v; the 2^w-th product is computed and dropped,
    # as the JAX scan computes it
    table, prev = [], one_r
    for _ in range(1 << window_bits):
        table.append(prev)
        prev = modmul(ctx, prev, a_r, impl)
    table = torch.stack(table, dim=1)                         # (batch, 2^w, m)

    lanes = torch.arange(batch, device=a.device)
    n_win = e.shape[-1] * LOG_BASE // window_bits
    wmask = (1 << window_bits) - 1
    r = one_r
    for i in range(n_win):
        start = (n_win - 1 - i) * window_bits                 # MSB first
        d = (e[:, start // LOG_BASE] >> (start % LOG_BASE)) & wmask
        for _ in range(window_bits):
            r = modmul(ctx, r, r, impl)
        r = modmul(ctx, r, table[lanes, d.long()], impl)
    return r


# ---------------------------------------------------------------------------
# batched entry points
# ---------------------------------------------------------------------------

def reduce_batch(x: torch.Tensor, v: torch.Tensor,
                 impl: str | None = None) -> torch.Tensor:
    """Per-lane moduli: x (batch, <= 2m), v (batch, m); the precompute
    runs in the call."""
    return barrett_reduce(barrett_precompute(v, impl), x, impl)


def modmul_batch(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
                 impl: str | None = None) -> torch.Tensor:
    return modmul(barrett_precompute(v, impl), a, b, impl)


def modexp_batch(a: torch.Tensor, e: torch.Tensor, v: torch.Tensor,
                 window_bits: int = 4,
                 impl: str | None = None) -> torch.Tensor:
    """Per-lane moduli: the precompute runs in the call (no
    amortization)."""
    return modexp(barrett_precompute(v, impl), a, e,
                  window_bits=window_bits, impl=impl)


# Shared-modulus variants: one context (cached by the service) for the
# whole batch, the amortized hot path.

def _shared(ctx: BarrettContext) -> BarrettContext:
    if not ctx.shared:
        raise ValueError("expected a shared context (v of shape (m,))")
    return ctx


def reduce_shared(ctx: BarrettContext, x: torch.Tensor,
                  impl: str | None = None) -> torch.Tensor:
    return barrett_reduce(_shared(ctx), x, impl)


def modmul_shared(ctx: BarrettContext, a: torch.Tensor, b: torch.Tensor,
                  impl: str | None = None) -> torch.Tensor:
    return modmul(_shared(ctx), a, b, impl)


def modexp_shared(ctx: BarrettContext, a: torch.Tensor, e: torch.Tensor,
                  window_bits: int = 4,
                  impl: str | None = None) -> torch.Tensor:
    return modexp(_shared(ctx), a, e, window_bits=window_bits, impl=impl)
