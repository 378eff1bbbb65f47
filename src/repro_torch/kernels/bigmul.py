"""Wrappers of the two standalone product kernels.

`mul_batch_cuda` (csrc/mul.cu) replaces
`repro/kernels/bigmul.py:mul_pallas_batched`: exact (u * v) mod
B^out_width as an 8-bit digit GEMM on the int8 tensor cores, an
instance spread over a thread-block cluster below 132 lanes
(`kernels/digitmma.py`); `kernels/ops.py:mul_plain` is its plain
version.

`mul_pairs` and `mulmod_pairs` (csrc/pairs.cu) replace `mul_pallas` and
`mulmod_pallas`, whose `_mul_kernel` summed tile pairs per output
diagonal: one block per (output diagonal, instance) writes the raw
per-diagonal sums, and `ops.columns_from_pairs` overlap-adds and
resolves them, on the card and on the CPU alike.  Their plain versions
`mul_pairs_reference` and `mulmod_pairs_reference` compute the same raw
sums with `ops.pair_sums_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import arith as A
from . import build, digitmma as D, ops
from .build import check_limbs, stream_ptr


def mul_batch_cuda(u: torch.Tensor, v: torch.Tensor,
                   out_width: int) -> torch.Tensor:
    """(batch, Wu) x (batch, Wv) int32 limbs on the card -> (batch,
    out_width): one kernel launch, on clusters of
    `digitmma.cluster_size(batch, sms)` blocks per instance."""
    if u.ndim != 2 or v.ndim != 2 or u.shape[0] != v.shape[0]:
        raise ValueError(f"expected (batch, W) operands with equal batch, "
                         f"got {tuple(u.shape)} x {tuple(v.shape)}")
    u, v = u.contiguous(), v.contiguous()
    check_limbs("u", u)
    check_limbs("v", v)
    batch, wu = u.shape
    wv = v.shape[1]
    D.check_contract(min(wu, out_width), min(wv, out_width))
    lib = build.lib("mul")
    if lib.mul_batch_smem_bytes(wu, wv, out_width) > D.DYNAMIC_SMEM_BYTES:
        raise ValueError("operands too wide for the shared-memory product")
    out = torch.empty(batch, out_width, dtype=torch.int32, device=u.device)
    if batch == 0:
        return out
    scratch = torch.empty(batch * lib.mul_batch_scratch_bytes(out_width),
                          dtype=torch.uint8, device=u.device)
    cluster = ctypes.c_int(D.cluster_size(batch, D.device_sms(u.device)))
    err = lib.mul_batch_launch(u.data_ptr(), v.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), batch, wu, wv, out_width,
                               ctypes.byref(cluster), stream_ptr(u))
    build.check(err, "mul_batch kernel")
    build.count("mul_batch")
    D.last_cluster["mul_batch"] = cluster.value
    return out


# column sums of the pair product stay < 2^48 up to this many limbs
# (the contract of ops.resolve_columns)
PAIRS_MAX_LIMBS = 1 << 16


def pair_sums_cuda(u: torch.Tensor, v: torch.Tensor,
                   d_keep: int) -> torch.Tensor:
    """Kernel of `ops.pair_sums_plain`: (batch, ndiag, 2T) int64 raw
    per-diagonal sums in one launch, one block per (diagonal,
    instance)."""
    if u.ndim != 2 or v.ndim != 2 or u.shape[0] != v.shape[0]:
        raise ValueError(f"expected (batch, W) operands with equal batch, "
                         f"got {tuple(u.shape)} x {tuple(v.shape)}")
    t = ops.BLOCK_T
    u = u[:, :d_keep * t].contiguous()
    v = v[:, :d_keep * t].contiguous()
    check_limbs("u", u)
    check_limbs("v", v)
    batch, wu = u.shape
    wv = v.shape[1]
    if min(wu, wv) > PAIRS_MAX_LIMBS or batch > 65535:
        raise ValueError(f"pair product of {wu} x {wv} limbs, batch "
                         f"{batch}: past the kernel's range")
    nu, nv = max(-(-wu // t), 1), max(-(-wv // t), 1)
    ndiag = min(nu + nv - 1, d_keep)
    raw = torch.empty(batch, ndiag, 2 * t, dtype=torch.int64,
                      device=u.device)
    if batch == 0 or wu == 0 or wv == 0:
        return raw.zero_()
    lib = build.lib("pairs")
    if lib.mul_pairs_tile() != t:
        raise RuntimeError("csrc/pairs.cu tile differs from ops.BLOCK_T")
    err = lib.mul_pairs_launch(u.data_ptr(), v.data_ptr(), raw.data_ptr(),
                               batch, wu, wv, ndiag, stream_ptr(u))
    build.check(err, "mul_pairs kernel")
    build.count("mul_pairs")
    return raw


def _pair_sums(u, v, d_keep):
    if ops._check_device(u, v) == "cuda":
        return pair_sums_cuda(u, v, d_keep)
    return ops.pair_sums_plain(u, v, d_keep)


def _mulmod(u, v, l_max, out_width, sums):
    l_max = min(l_max, out_width)
    r = ops.columns_from_pairs(sums(u, v, ops.tiles_for(l_max)), out_width)
    return A.mask_below(r, l_max) if l_max < out_width else r


def mul_pairs(u: torch.Tensor, v: torch.Tensor,
              out_width: int) -> torch.Tensor:
    """Exact (u * v) mod B^out_width of (batch, Wu) x (batch, Wv) limbs:
    one pair-kernel launch on the card (its plain version on the CPU),
    then the overlap-add and carry resolution in torch."""
    return _mulmod(u, v, out_width, out_width, _pair_sums)


def mulmod_pairs(u: torch.Tensor, v: torch.Tensor, l_max: int,
                 out_width: int) -> torch.Tensor:
    """The close product (u * v) mod B^l_max at out_width limbs (zero
    from limb l_max up), computing only the diagonals d < ceil(l_max /
    T) that can touch a limb below l_max (Algorithm 2's MULTMOD, as
    `mulmod_pallas` prunes)."""
    return _mulmod(u, v, l_max, out_width, _pair_sums)


def mul_pairs_reference(u: torch.Tensor, v: torch.Tensor,
                        out_width: int) -> torch.Tensor:
    """Plain version of `mul_pairs` on either device."""
    return _mulmod(u, v, out_width, out_width, ops.pair_sums_plain)


def mulmod_pairs_reference(u: torch.Tensor, v: torch.Tensor, l_max: int,
                           out_width: int) -> torch.Tensor:
    """Plain version of `mulmod_pairs` on either device."""
    return _mulmod(u, v, l_max, out_width, ops.pair_sums_plain)
