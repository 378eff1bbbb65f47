"""Whole-shifted-inverse division in PyTorch (Algorithms 1-3 of the paper).

The batched counterpart of `repro/core/shinv.py`: every function works
on (batch, W) int32 limb tensors with the batch axis written out, and
every per-instance scalar (h, k, hk, need, l, m, s, active) is a
(batch,) tensor on the operands' device.  The Refine loop has the same
static trip count `refine_iters(M)` and the same static window per
iteration as the JAX code, so nothing in it reads a value back to the
host: the set-up is one `prologue` launch, each iteration one
`kernels.ops.fused_step` and the finalization one `fused_correct`.
Under the default impl cuda_fused that is one set-up launch, two kernel
launches per iteration and one for the finalization on CUDA,
2 * refine_iters + 2 per batched division; the other impls and the CPU
run the set-up in torch ops (`prologue_plain`).  `impl` picks another
rung of the registry (`kernels/ops.py`) with the same result bit for
bit.

Spans (`obs/telemetry.py:scope`): `divmod_batch` opens `divmod` over
the whole call, and inside it `divmod/prologue` (the operands' pad,
prec(u) and the inverse's set-up), one `refine_iter_{i}` per iteration
with its `fused_step` last, `divmod/epilogue` (the final shift and the
special cases' answers) and `fused_correct`; `shinv_batch` alone opens
the iterations'.  Under a bucket executable's capture they are device
marks that replay with the graph.

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
from repro_torch.kernels import bigmul, fused as F, ops as K
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


def prologue_plain(v: torch.Tensor, h: torch.Tensor | None = None,
                   u: torch.Tensor | None = None):
    """The division's set-up in torch ops: the plain version of
    `kernels/fused.py:prologue_cuda`, which the CPU and every impl but
    cuda_fused run.  With u: u and v (batch, M) limbs, padded to W = M +
    PAD, and h = prec(u); without: v (batch, W) as it is and the given h
    (batch,).

    Returns (uw, vw, vl, w, scal, flags): uw the padded u (None without
    u), vw the padded v (v itself without u), vl the lifted v, w the
    first iterate, scal the (batch,) int32 (h, k, hk, need, l) and
    flags the (batch,) bool (case_zero, case_one, case_pow)."""
    uw = None
    if u is not None:
        pad = (0, PAD)
        uw = torch.nn.functional.pad(u.to(DTYPE), pad).contiguous()
        v = torch.nn.functional.pad(v.to(DTYPE), pad).contiguous()
        h = A.prec(uw)
    h = h.to(device=v.device, dtype=DTYPE)
    vw, h_in = v, h

    # lift single-limb v: floor(B^(h+1) / vB) == floor(B^h / v)
    small = A.prec(v) <= 1
    v = torch.where(small[:, None], A.shift(v, 1), v)
    h = h + small.to(DTYPE)
    k = A.prec(v) - 1

    # special cases (leave B < v <= B^h / 2 for the general path)
    two_v = A.add(v, v)
    case_zero = A.gt_pow(v, h)                        # v >  B^h -> 0
    case_one = A.gt_pow(two_v, h) & ~case_zero        # 2v > B^h -> 1
    case_pow = A.is_pow(v)                            # v == B^k

    # initial approximation from the two most significant limbs
    V = (A.take_limb(v, k - 1).to(torch.int64)
         + (A.take_limb(v, k).to(torch.int64) << LOG_BASE))
    w0 = torch.zeros_like(v)
    w0[:, 0], w0[:, 1], w0[:, 2] = _initial_w0(V)

    # the refinement's set-up
    l = torch.full_like(h, 2)
    w = A.shift(w0, GUARD)
    hk = h - k
    need = torch.where(hk - 1 >= 2, A.ceil_log2(torch.clamp(hk - 1, min=1)),
                       0) + 2
    return (uw, vw, v, w, (h_in, k, hk, need, l),
            (case_zero, case_one, case_pow))


class _Inverse:
    """shinv_h(v) + lambda, lambda in {0, 1} (Theorem 2), per row, in
    the three stretches of device work that a division's spans name:
    the set-up (the constructor: the lift of single-limb v, the special
    cases, the initial approximation and the refinement's set-up),
    `refine` (the guarded shorter-iterate/divisor-prefix loop) and
    `select` (the final shift and the special cases' answers).  v:
    (batch, W) limbs, h: (batch,) int32; or, for a division, u and v
    (batch, M) limbs and h None, which the set-up pads to W (`u`,
    `v_in`) with h = prec(u) (`h_in`).  The set-up is one `prologue`
    launch under cuda_fused on CUDA (`kernels/fused.py:prologue_cuda`),
    else `prologue_plain`."""

    def __init__(self, v: torch.Tensor, h: torch.Tensor | None,
                 impl: str | None = None, u: torch.Tensor | None = None):
        if K.runs_fused(impl, *((v,) if u is None else (u, v))):
            got = F.prologue_cuda(
                v.to(DTYPE).contiguous(), h=h,
                u=None if u is None else u.to(DTYPE).contiguous())
        else:
            got = prologue_plain(v, h, u)
        self.u, self.v_in, self.v, self.w, scal, flags = got
        self.h_in, self.k, self.hk, self.need, self.l = scal
        self.case_zero, self.case_one, self.case_pow = flags
        self.width = self.v.shape[-1]

    def refine(self, iters_max: int, windowed: bool = True,
               impl: str | None = None) -> None:
        """The loop; iteration i runs at the static window
        `refine_window(i, width, windowed)`, under the span
        `refine_iter_{i}`, with its `fused_step` last."""
        g, v, k = GUARD, self.v, self.k
        w, l, hk, need = self.w, self.l, self.hk, self.need
        for i in range(iters_max):
            with T.scope(f"refine_iter_{i}"):
                wi = refine_window(i, self.width, windowed)
                active = i < need
                m = torch.clamp(torch.minimum(hk + 1 - l, l), min=0)
                s = torch.clamp(k - 2 * l + 1 - g, min=0)
                l_next = torch.where(active, l + m - 1, l)
                w = K.fused_step(v, w, h=k + l + m - s + g, m=m, l=l, s=s,
                                 active=active, g=g, win=wi, impl=impl)
            l = l_next
        self.w, self.l = w, l

    def select(self) -> torch.Tensor:
        """The refined iterate shifted into place, and the special
        cases' answers; rows with v = 0 give 0."""
        w = A.shift(self.w, self.hk - self.l - GUARD)
        w = torch.where(self.case_pow[:, None],
                        one_hot_pow(self.hk, self.width), w)
        w = torch.where(self.case_one[:, None],
                        one_hot_pow(torch.zeros_like(self.h_in), self.width),
                        w)
        zero = (self.case_zero | A.is_zero(self.v_in))[:, None]
        return torch.where(zero, torch.zeros_like(w), w)


def shinv_batch(v: torch.Tensor, h: torch.Tensor, iters_max: int,
                windowed: bool = True,
                impl: str | None = None) -> torch.Tensor:
    """shinv_h(v) + lambda, lambda in {0, 1} (Theorem 2), per row.
    v: (batch, W) limbs, h: (batch,) int32.  Rows with v = 0 give 0."""
    inv = _Inverse(v, h, impl)
    inv.refine(iters_max, windowed, impl)
    return inv.select()


def check_width(device, m: int, impl: str | None = None) -> None:
    """Raise ValueError where impl's kernels cannot run an m-limb division
    on `device`, before any launch (`ops.check_fit`): on CUDA, cuda_fused
    stages the step kernels at the last Refine window, which is the full
    working width W = m + PAD, and the finalization kernel at W;
    cuda_batched the product kernel at W x W -> 2W (u * shinv).
    cuda_pairs, blocked and the CPU have no cap."""
    width = m + PAD
    K.check_fit(device, impl, width, f"a division of {m} limbs",
                cuda_fused=lambda: (F.step_fit(width), F.correct_fit(width)),
                cuda_batched=lambda: bigmul.mul_batch_fit(width, width,
                                                          2 * width))


def divmod_batch(u: torch.Tensor, v: torch.Tensor, windowed: bool = True,
                 impl: str | None = None):
    """Batched division (q, r) with u = q * v + r, 0 <= r < v; u, v:
    (batch, M) int32 limbs on one device, which the computation follows
    (CUDA: `costmodel.divmod_launches(M, impl)` +
    `costmodel.prologue_launches(impl)` kernel launches, 2 *
    refine_iters(M) + 2 under cuda_fused, after `check_width`).
    divmod(u, 0) = (0, u)."""
    if u.shape != v.shape or u.ndim != 2:
        raise ValueError(f"expected equal (batch, M) operands, got "
                         f"{tuple(u.shape)} and {tuple(v.shape)}")
    m_limbs = u.shape[1]
    check_width(u.device, m_limbs, impl)
    with T.scope("divmod"):
        with T.scope("divmod/prologue"):
            inv = _Inverse(v, None, impl, u=u)
        inv.refine(refine_iters(m_limbs), windowed, impl)
        with T.scope("divmod/epilogue"):
            si = inv.select()
        q, r = K.fused_correct(inv.u, inv.v_in, si, h=inv.h_in, impl=impl)
    return q[:, :m_limbs], r[:, :m_limbs]


def shinv_fixed(v: torch.Tensor, h, *, iters_max: int,
                impl: str | None = None,
                windowed: bool = True) -> torch.Tensor:
    """One instance of `shinv_batch` (JAX's shinv_fixed): v (W,) limbs,
    h an int or a 0-d tensor."""
    h = torch.as_tensor(h, dtype=DTYPE, device=v.device).reshape(1)
    return shinv_batch(v[None], h, iters_max, windowed=windowed,
                       impl=impl)[0]


def divmod_fixed(u: torch.Tensor, v: torch.Tensor, impl: str | None = None,
                 windowed: bool = True):
    """One instance of `divmod_batch` (JAX's divmod_fixed): u, v (M,)
    limbs; divmod(u, 0) = (0, u)."""
    q, r = divmod_batch(u[None], v[None], windowed=windowed, impl=impl)
    return q[0], r[0]
