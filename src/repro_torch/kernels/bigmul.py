"""Wrapper of the standalone batched product kernel (csrc/mul.cu).

Replaces `repro/kernels/bigmul.py:mul_pallas_batched`.  The kernel runs
one thread block per instance and computes exact (u * v) mod
B^out_width from 64-bit column sums; `kernels/ops.py:mul_plain` is its
plain version.
"""

from __future__ import annotations

import torch

from . import build
from .build import SMEM_BYTES, check_limbs, stream_ptr


def mul_batch_cuda(u: torch.Tensor, v: torch.Tensor,
                   out_width: int) -> torch.Tensor:
    """(batch, Wu) x (batch, Wv) int32 limbs on the card -> (batch,
    out_width): one kernel launch."""
    if u.ndim != 2 or v.ndim != 2 or u.shape[0] != v.shape[0]:
        raise ValueError(f"expected (batch, W) operands with equal batch, "
                         f"got {tuple(u.shape)} x {tuple(v.shape)}")
    u, v = u.contiguous(), v.contiguous()
    check_limbs("u", u)
    check_limbs("v", v)
    batch, wu = u.shape
    wv = v.shape[1]
    if 4 * (min(wu, out_width) + min(wv, out_width)) > SMEM_BYTES:
        raise ValueError("operands too wide for the shared-memory product")
    lib = build.lib("mul")
    out = torch.empty(batch, out_width, dtype=torch.int32, device=u.device)
    if batch == 0:
        return out
    scratch = torch.empty(batch * lib.mul_batch_scratch_bytes(out_width),
                          dtype=torch.uint8, device=u.device)
    err = lib.mul_batch_launch(u.data_ptr(), v.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), batch, wu, wv, out_width,
                               stream_ptr(u))
    build.check(err, "mul_batch kernel")
    build.count("mul_batch")
    return out
