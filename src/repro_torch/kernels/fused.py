"""Fused division-step and Barrett kernels and their plain versions.

One Refine iteration is two kernel launches, the divmod finalization
one and a Barrett reduction one, as in the JAX package
(`repro/kernels/fused.py`):

  powdiff   csrc/step.cu    replaces _powdiff_kernel, _powdiff_grid_kernel
  update    csrc/step.cu    replaces _update_kernel, _update_grid_kernel
  correct   csrc/correct.cu replaces _correct_kernel, _correct_grid_kernel
  barrett   csrc/barrett.cu replaces _barrett_kernel, _barrett_grid_kernel

The TPU's two kernel generations computed the same functions (they
differed only in how the product fit VMEM); on Hopper one kernel per
stage covers every width.  All four compute their products as int8
digit GEMMs with an instance spread over a cluster
(`csrc/digitmma.cuh`, `kernels/digitmma.py`); their wrappers ask the
library whether a width's staging fits shared memory
(`step_smem_bytes`, `correct_smem_bytes`, `barrett_smem_bytes`), and
record the cluster size each launch used in `digitmma.last_cluster`.
`powdiff_reference`,
`update_reference`, `step_reference`, `correct_reference` and
`barrett_reference` are the plain PyTorch versions (the JAX package's
`_powdiff_reference`, `step_reference`, `correct_reference` and
`barrett_reference`, batched).  Each takes the product as `mul`
(default the plain `mul_plain`): `kernels/ops.py` runs them for CPU
tensors and, with the impl's product, for every impl but cuda_fused,
and the tests and `chip_smoke.py` hold the kernels to them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import arith as A
from repro_torch.core.bigint import DTYPE, one_hot_pow
from . import build, digitmma as D
from .build import check_limbs
from .ops import mul_plain


def _pad_to(x: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _row(c: torch.Tensor) -> torch.Tensor:
    return c[:, None]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def powdiff_reference(v, w, hpd, lpd, s, *, win: int, mul=mul_plain):
    """Launch 1 of a Refine iteration: (sign, x = |B^hpd - vp * wq|) per
    Algorithm 2, with vp = shift(v, -s) and wq = w, both cut to the
    window.  hpd = h - m and lpd = l - g, (batch,) int32.  Returns sign
    (batch,) bool and x (batch, W), zero above the window.  `mul` is
    the product (u, v, out_width) -> limbs."""
    width = v.shape[-1]
    vp = A.shift(v, -s)[:, :win]
    wq = w[:, :win]
    pv, pw = A.prec(vp), A.prec(wq)
    L = pv + pw - lpd + 1
    p = mul(vp, wq, 2 * win)

    vwz = A.is_zero(vp) | A.is_zero(wq)
    full = vwz | (L >= hpd)
    # full branch: compare p with B^h
    sign_full = A.prec(p) <= hpd
    mag_pos = A.neg_mod_pow(p, hpd)[:, :win]
    mag_neg = A.sub_pow(p, hpd)[:, :win]
    x_full = torch.where(_row(sign_full), mag_pos, mag_neg)
    x_full = torch.where(_row(vwz), one_hot_pow(hpd, win), x_full)
    # close branch: P = (v * w) mod B^L, sign from the top digit of P
    P = A.mask_below(p, L)[:, :win]
    p_zero = A.is_zero(P)
    p_top = A.take_limb(P, L - 1)
    sign_close = p_zero | (p_top != 0)
    x_close = torch.where(
        _row(p_zero), torch.zeros_like(P),
        torch.where(_row(p_top == 0), P, A.neg_mod_pow(P, L)[:, :win]))

    sign = torch.where(full, sign_full, sign_close)
    x = torch.where(_row(full), x_full, x_close)
    return sign, _pad_to(x, width)


def update_reference(w, x, sign, h, m, active, *, win: int, mul=mul_plain):
    """Launch 2 of a Refine iteration: tmp = wq * x, shift(wq, m) +/-
    floor(tmp / B^(h-2m)), the -1 normalization shift, and the
    active-lane select back into the full-width iterate."""
    width = w.shape[-1]
    w2 = 2 * win
    wq = w[:, :win]
    tmp = mul(wq, x[:, :win], w2)
    sh = A.shift(tmp, 2 * m - h)[:, :win]         # 2m - h <= 0 here
    wm = A.shift(wq, m)
    res_pos = A.add(wm, sh)
    res_neg = A.sub(wm, sh)
    # floor correction: dropped limbs of tmp nonzero -> one more off
    idx = torch.arange(w2, dtype=DTYPE, device=w.device)
    dropped = ((idx < _row(h - 2 * m)) & (tmp != 0)).any(dim=-1)
    res_neg = torch.where(_row(dropped), A.sub_scalar(res_neg, 1), res_neg)
    w_new = torch.where(_row(sign), res_pos, res_neg)
    w_new = _pad_to(A.shift(w_new, -1), width)
    return torch.where(_row(active), w_new, w)


def step_reference(v, w, *, h, m, l, s, active, g: int, win: int,
                   mul=mul_plain):
    """One Refine iteration as the plain composition with the product
    `mul` (the JAX package's `kernels/fused.py:step_reference`,
    batched)."""
    sign, x = powdiff_reference(v, w, h - m, l - g, s, win=win, mul=mul)
    return update_reference(w, x, sign, h, m, active, win=win, mul=mul)


def correct_reference(u, v, si, *, h, mul=mul_plain):
    """Algorithm 3 finalization with the delta in {-1, 0, +1}
    correction; divmod(u, 0) = (0, u)."""
    width = u.shape[-1]
    p = mul(u, si, 2 * width)                     # double-width product
    q = A.shift(p, -h)[:, :width]
    mm = mul(v, q, width)                         # v * q fits the width

    d_neg = A.lt(u, mm)                           # delta = -1
    q = torch.where(_row(d_neg), A.sub_scalar(q, 1), q)
    mm = torch.where(_row(d_neg), A.sub(mm, v), mm)
    r = A.sub(u, mm)
    d_pos = A.ge(r, v)                            # delta = +1
    q = torch.where(_row(d_pos), A.add_scalar(q, 1), q)
    r = torch.where(_row(d_pos), A.sub(r, v), r)
    vz = _row(A.is_zero(v))
    return torch.where(vz, 0, q), torch.where(vz, u, r)


def _rows(a: torch.Tensor, batch: int, width: int) -> torch.Tensor:
    """A (w,) operand shared by every lane or a (batch, w) one, as a
    (batch, width) view, zero-padded to width."""
    a = _pad_to(a, width)
    return a.expand(batch, width) if a.ndim == 1 else a


def barrett_branches(x, mu, v, *, h: int, mul=mul_plain):
    """The Barrett reduction core as the plain composition, and the
    correction each lane took: (r, over, under).

    x: (batch, <= W) limbs; mu: (W,) or (batch, W), the cached
    shinv_h(v) + lambda; v: (<= W,) or (batch, <= W); h a static int.
    p = x * mu to 2W limbs, q = floor(p / B^h) cut to W, qv = (q * v)
    mod B^W; `over` (qhat = q + 1) is x < qv before the subtraction,
    `under` (qhat = q - 1) is r >= v after it.  r is (batch, W)."""
    width = mu.shape[-1]
    batch = x.shape[0]
    x = _pad_to(x, width)
    mu = _rows(mu, batch, width)
    v = _rows(v, batch, width)
    p = mul(x, mu, 2 * width)
    q = A.shift(p, -h)[:, :width]
    qv = mul(q, v, width)

    over = A.lt(x, qv)                            # qhat = q + 1
    qv = torch.where(_row(over), A.sub(qv, v), qv)
    r = A.sub(x, qv)
    under = A.ge(r, v)                            # qhat = q - 1
    r = torch.where(_row(under), A.sub(r, v), r)
    return r, over, under


def barrett_reference(x, mu, v, *, h: int, mul=mul_plain):
    """Barrett reduction core (two truncated products + two conditional
    subtracts) -> r (batch, W); see `barrett_branches`."""
    return barrett_branches(x, mu, v, h=h, mul=mul)[0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _scalars(batch: int, device, **cols) -> dict[str, torch.Tensor]:
    """Per-instance scalars as contiguous (batch,) int32 on the card.  A
    Python int becomes a device fill, not a copy from the host, so a
    wrapper can be captured in a CUDA graph whatever it is given."""
    out = {}
    for name, c in cols.items():
        c = c.to(device=device, dtype=torch.int32) \
            if isinstance(c, torch.Tensor) \
            else torch.full((), int(c), dtype=torch.int32, device=device)
        out[name] = c.expand(batch).contiguous() if c.ndim == 0 \
            else c.contiguous()
        check_limbs(name, out[name], (batch,))
    return out


def _step_lib(win: int, batch: int, full_w: int, **arrs):
    """Check a step launch's limb operands and window; returns the step
    library once it says the window's staging fits shared memory."""
    if not 1 <= win <= full_w:
        raise ValueError(f"window {win} outside [1, {full_w}]")
    for name, a in arrs.items():
        check_limbs(name, a, (batch, full_w))
    D.check_contract(win, win)
    lib = build.lib("step")
    if lib.step_smem_bytes(win) > D.DYNAMIC_SMEM_BYTES:
        raise ValueError(f"a {win}-limb window exceeds shared memory")
    return lib


def _step_launch(lib, kernel: str, batch: int, full_w: int, win: int,
                 device, *ptrs) -> None:
    """One launch of a step kernel on clusters of
    `digitmma.cluster_size(batch, sms)` blocks per instance."""
    scratch = torch.empty(batch * lib.step_scratch_bytes(win),
                          dtype=torch.uint8, device=device)
    cluster = ctypes.c_int(D.cluster_size(batch, D.device_sms(device)))
    with build.on_device(scratch) as stream:
        err = getattr(lib, f"{kernel}_launch")(
            *ptrs, scratch.data_ptr(), batch, full_w, win,
            ctypes.byref(cluster), stream)
    build.check(err, f"{kernel} kernel")
    build.count(kernel)
    D.last_cluster[kernel] = cluster.value


def powdiff_cuda(v, w, hpd, lpd, s, *, win: int):
    """Kernel of `powdiff_reference`: returns sign (batch,) bool and
    x (batch, W)."""
    sign, x = _powdiff_launch(v, w, hpd, lpd, s, win=win)
    return sign != 0, x


def _powdiff_launch(v, w, hpd, lpd, s, *, win: int):
    """The powdiff launch; the sign stays (batch,) int32 0/1, as
    `update_cuda` takes it."""
    batch, full_w = v.shape
    lib = _step_lib(win, batch, full_w, v=v, w=w)
    sc = _scalars(batch, v.device, hpd=hpd, lpd=lpd, s=s)
    sign = torch.empty(batch, dtype=torch.int32, device=v.device)
    x = torch.empty_like(v)
    if batch:
        _step_launch(lib, "powdiff", batch, full_w, win, v.device,
                     v.data_ptr(), w.data_ptr(), sc["hpd"].data_ptr(),
                     sc["lpd"].data_ptr(), sc["s"].data_ptr(),
                     sign.data_ptr(), x.data_ptr())
    return sign, x


def update_cuda(w, x, sign, h, m, active, *, win: int):
    """Kernel of `update_reference`: the new full-width iterate.  `sign`
    is bool or int32 0/1 (int32 costs no conversion)."""
    batch, full_w = w.shape
    lib = _step_lib(win, batch, full_w, w=w, x=x)
    sc = _scalars(batch, w.device, sign=sign, h=h, m=m, act=active)
    out = torch.empty_like(w)
    if batch:
        _step_launch(lib, "update", batch, full_w, win, w.device,
                     w.data_ptr(), x.data_ptr(), sc["sign"].data_ptr(),
                     sc["h"].data_ptr(), sc["m"].data_ptr(),
                     sc["act"].data_ptr(), out.data_ptr())
    return out


def step_cuda(v, w, *, h, m, l, s, active, g: int, win: int):
    """One Refine iteration in two launches (powdiff, update)."""
    sign, x = _powdiff_launch(v, w, h - m, l - g, s, win=win)
    return update_cuda(w, x, sign, h, m, active, win=win)


def correct_cuda(u, v, si, *, h):
    """Kernel of `correct_reference`: (q, r) in one launch, an instance
    spread over a cluster of `digitmma.cluster_size(batch, sms)`
    blocks."""
    batch, full_w = u.shape
    for name, a in (("u", u), ("v", v), ("si", si)):
        check_limbs(name, a, (batch, full_w))
    D.check_contract(full_w, full_w)
    lib = build.lib("correct")
    if lib.correct_smem_bytes(full_w) > D.DYNAMIC_SMEM_BYTES:
        raise ValueError(f"a {full_w}-limb finalization exceeds shared "
                         f"memory")
    sc = _scalars(batch, u.device, h=h)
    q = torch.empty_like(u)
    r = torch.empty_like(u)
    if batch:
        scratch = torch.empty(batch * lib.correct_scratch_bytes(full_w),
                              dtype=torch.uint8, device=u.device)
        cluster = ctypes.c_int(D.cluster_size(batch, D.device_sms(u.device)))
        with build.on_device(u) as stream:
            err = lib.correct_launch(
                u.data_ptr(), v.data_ptr(), si.data_ptr(),
                sc["h"].data_ptr(), q.data_ptr(), r.data_ptr(),
                scratch.data_ptr(), batch, full_w, ctypes.byref(cluster),
                stream)
        build.check(err, "correct kernel")
        build.count("correct")
        D.last_cluster["correct"] = cluster.value
    return q, r


def barrett_cuda(x, mu, v, *, h: int):
    """Kernel of `barrett_reference`: r (batch, W) in one launch, an
    instance spread over a cluster of `digitmma.cluster_size(batch,
    sms)` blocks.  A shared (W,) mu or (<= W,) v is read by every lane
    through a row stride of 0, never copied per lane."""
    full_w = mu.shape[-1]
    if x.ndim != 2 or x.shape[1] > full_w or v.shape[-1] > full_w:
        raise ValueError(f"expected x (batch, <= {full_w}) and v (<= "
                         f"{full_w}) limbs, got {tuple(x.shape)}, "
                         f"{tuple(v.shape)}")
    if not 0 <= h <= 2 * full_w:
        raise ValueError(f"shift {h} outside [0, {2 * full_w}]")
    batch, nx = x.shape
    strides = {}
    for name, a in (("mu", mu), ("v", v)):
        check_limbs(name, a)
        if a.ndim == 2 and a.shape[0] != batch:
            raise ValueError(f"{name}: {a.shape[0]} rows for {batch} lanes")
        strides[name] = a.shape[-1] if a.ndim == 2 else 0
    check_limbs("x", x)
    D.check_contract(full_w, v.shape[-1])
    lib = build.lib("barrett")
    if lib.barrett_smem_bytes(nx, v.shape[-1], full_w) > D.DYNAMIC_SMEM_BYTES:
        raise ValueError(f"a {full_w}-limb Barrett window exceeds shared "
                         f"memory")
    r = torch.empty(batch, full_w, dtype=torch.int32, device=x.device)
    if batch:
        scratch = torch.empty(batch * lib.barrett_scratch_bytes(full_w),
                              dtype=torch.uint8, device=x.device)
        cluster = ctypes.c_int(D.cluster_size(batch, D.device_sms(x.device)))
        with build.on_device(x) as stream:
            err = lib.barrett_launch(
                x.data_ptr(), mu.data_ptr(), v.data_ptr(), r.data_ptr(),
                scratch.data_ptr(), batch, nx, strides["mu"], v.shape[-1],
                strides["v"], full_w, h, ctypes.byref(cluster), stream)
        build.check(err, "barrett kernel")
        build.count("barrett")
        D.last_cluster["barrett"] = cluster.value
    return r
