"""Whole-shifted-inverse division in PyTorch (Algorithms 1-3 of the paper).

The batched counterpart of `repro/core/shinv.py`: every function works
on (batch, W) int32 limb tensors with the batch axis written out, and
every per-instance scalar (h, k, hk, need, l, m, s, active) is a
(batch,) tensor on the operands' device.  The Refine loop has the same
static trip count `refine_iters(M)` and the same static window per
iteration as the JAX code, so nothing in it reads a value back to the
host: each iteration is one `kernels.ops.fused_step` and the
finalization one `fused_correct`.  Under the default impl cuda_fused
that is two kernel launches per iteration and one for the finalization
on CUDA, 2 * refine_iters + 1 per batched division; `impl` picks
another rung of the registry (`kernels/ops.py`) with the same result
bit for bit.

Zero-divisor contract (as in the JAX package): divmod(u, 0) = (0, u)
and shinv(0, h) = 0.

Width cap on the card: under cuda_fused and cuda_batched the kernels
stage their operands in shared memory at the working width W = M + PAD,
so `divmod_batch` asks the kernel libraries first (`check_width`) and
raises ValueError before any launch past 38,440 limbs under cuda_fused
(the finalization kernel's u, si and v) and 57,744 under cuda_batched
(u * shinv); cuda_pairs, blocked and the CPU have no cap, and nothing
reroutes on its own.
"""

from __future__ import annotations

import torch

from .bigint import DTYPE, LOG_BASE, MASK, one_hot_pow
from . import arith as A
from repro_torch.kernels import digitmma as D, ops as K
from repro_torch.obs import telemetry as T
from repro_torch.obs.costmodel import PAD, refine_iters, refine_window

GUARD = 2   # guard digits g (paper: Refine line 16)
# PAD (costmodel.PAD): extra limbs of internal headroom above M


def _initial_w0(V: torch.Tensor):
    """floor(B^3 / V) for V in [B, B^2), as three base-B limbs (d0, d1,
    d2), each (batch,) int32.

    q1 = floor(2^32 / V) and the 16-step restoring division of the
    remainder run in int64.  They reproduce the JAX package's uint32
    arithmetic bit for bit on every V in [0, 2^32): V = 0 is raised to
    1 (that lane's result is masked later), and the uint32 wrap of q1
    at V = 1 is kept."""
    V = torch.clamp(V.to(torch.int64), min=1)
    two32 = 1 << 32
    q1 = ((two32 - V) // V + 1) % two32           # the uint32 wrap at V = 1
    t = (two32 - q1 * V) % two32                  # 2^32 - q1 * V, < V
    q2 = torch.zeros_like(V)
    for _ in range(LOG_BASE):
        t = t << 1
        geq = t >= V
        t = torch.where(geq, t - V, t)
        q2 = (q2 << 1) | geq.to(torch.int64)
    return ((q2 & MASK).to(DTYPE), (q1 & MASK).to(DTYPE),
            (q1 >> LOG_BASE).to(DTYPE))


def _refine(v, h, k, w, *, width: int, iters_max: int, windowed: bool = True,
            impl: str | None = None):
    """Guarded shorter-iterate/divisor-prefix refinement loop; iteration
    i runs at the static window `refine_window(i, width, windowed)`."""
    g = GUARD
    l = torch.full_like(h, 2)
    w = A.shift(w, g)
    hk = h - k
    need = torch.where(hk - 1 >= 2, A.ceil_log2(torch.clamp(hk - 1, min=1)),
                       0) + 2
    for i in range(iters_max):
        wi = refine_window(i, width, windowed)
        active = i < need
        m = torch.clamp(torch.minimum(hk + 1 - l, l), min=0)
        s = torch.clamp(k - 2 * l + 1 - g, min=0)
        with T.scope(f"refine_iter_{i}"):
            w = K.fused_step(v, w, h=k + l + m - s + g, m=m, l=l, s=s,
                             active=active, g=g, win=wi, impl=impl)
        l = torch.where(active, l + m - 1, l)
    return A.shift(w, h - k - l - g)


def shinv_batch(v: torch.Tensor, h: torch.Tensor, iters_max: int,
                windowed: bool = True,
                impl: str | None = None) -> torch.Tensor:
    """shinv_h(v) + lambda, lambda in {0, 1} (Theorem 2), per row.
    v: (batch, W) limbs, h: (batch,) int32.  Rows with v = 0 give 0."""
    width = v.shape[-1]
    h = h.to(device=v.device, dtype=DTYPE)

    # lift single-limb v: floor(B^(h+1) / vB) == floor(B^h / v)
    small = A.prec(v) <= 1
    v_eff = torch.where(small[:, None], A.shift(v, 1), v)
    h_eff = h + small.to(DTYPE)
    k = A.prec(v_eff) - 1

    # special cases (leave B < v <= B^h / 2 for the general path)
    two_v = A.add(v_eff, v_eff)
    case_zero = A.gt_pow(v_eff, h_eff)                    # v >  B^h -> 0
    case_one = A.gt_pow(two_v, h_eff) & ~case_zero        # 2v > B^h -> 1
    case_pow = A.is_pow(v_eff)                            # v == B^k

    # initial approximation from the two most significant limbs
    V = (A.take_limb(v_eff, k - 1).to(torch.int64)
         + (A.take_limb(v_eff, k).to(torch.int64) << LOG_BASE))
    w0 = torch.zeros_like(v)
    w0[:, 0], w0[:, 1], w0[:, 2] = _initial_w0(V)

    w = _refine(v_eff, h_eff, k, w0, width=width, iters_max=iters_max,
                windowed=windowed, impl=impl)

    w = torch.where(case_pow[:, None], one_hot_pow(h_eff - k, width), w)
    w = torch.where(case_one[:, None], one_hot_pow(torch.zeros_like(h), width),
                    w)
    zero = (case_zero | A.is_zero(v))[:, None]
    return torch.where(zero, torch.zeros_like(w), w)


def check_width(device, m: int, impl: str | None = None) -> None:
    """Raise ValueError where impl's kernels cannot run an m-limb division
    on `device`, before any launch (`digitmma.check_staging`): on CUDA,
    cuda_fused stages the step kernels at the last Refine window, which
    is the full working width W = m + PAD, and the finalization kernel
    at W; cuda_batched the product kernel at W x W -> 2W (u * shinv).
    cuda_pairs, blocked and the CPU have no cap."""
    width = m + PAD

    def need(libs, impl):
        if impl == "cuda_fused":
            return max(libs["step"].step_smem_bytes(width),
                       libs["correct"].correct_smem_bytes(width))
        return libs["mul"].mul_batch_smem_bytes(width, width, 2 * width)

    D.check_staging(device, impl, width, f"a division of {m} limbs", need)


def divmod_batch(u: torch.Tensor, v: torch.Tensor, windowed: bool = True,
                 impl: str | None = None):
    """Batched division (q, r) with u = q * v + r, 0 <= r < v; u, v:
    (batch, M) int32 limbs on one device, which the computation follows
    (CUDA: `costmodel.divmod_launches(M, impl)` kernel launches,
    2 * refine_iters(M) + 1 under cuda_fused, after `check_width`).
    divmod(u, 0) = (0, u)."""
    if u.shape != v.shape or u.ndim != 2:
        raise ValueError(f"expected equal (batch, M) operands, got "
                         f"{tuple(u.shape)} and {tuple(v.shape)}")
    m_limbs = u.shape[1]
    check_width(u.device, m_limbs, impl)
    pad = (0, PAD)
    uw = torch.nn.functional.pad(u.to(DTYPE), pad).contiguous()
    vw = torch.nn.functional.pad(v.to(DTYPE), pad).contiguous()
    h = A.prec(uw)
    si = shinv_batch(vw, h, refine_iters(m_limbs), windowed=windowed,
                     impl=impl)
    q, r = K.fused_correct(uw, vw, si, h=h, impl=impl)
    return q[:, :m_limbs], r[:, :m_limbs]
