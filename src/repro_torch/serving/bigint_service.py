"""Batched multi-precision division service on the card.

Requests are Python ints; the service validates them, packs each chunk
of a request into a bucket-sized (bucket, m_limbs) limb batch on its
device, runs `core.shinv.divmod_batch` there, and unpacks exact
results.  The port of `repro/serving/bigint_service.py` without fault
injection, impl overrides or trace profiles.
"""

from __future__ import annotations

import torch

from repro_torch.core import bigint as bi
from repro_torch.core import shinv as S
from . import batching as BT
from . import errors as E


class BigintDivisionService:
    def __init__(self, m_limbs: int, batch_buckets=(64, 256, 1024),
                 device="cuda"):
        self.m = m_limbs
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BigintDivisionService(device='cuda') needs "
                               "a CUDA device; pass device='cpu' to run "
                               "the plain versions on the CPU")
        self.batcher = BT.Batcher(batch_buckets)
        self.telemetry = BT.ServiceMetrics()

    @property
    def buckets(self):
        return list(self.batcher.buckets)

    def validate(self, op: str, columns) -> int:
        """Full request validation (types, ranges, column lengths);
        returns the request length."""
        if op != "divmod":
            raise E.InvalidRequest(f"unknown op {op!r} for "
                                   "BigintDivisionService")
        n = E.check_lengths(columns, names=("us", "vs"))
        lim = bi.BASE ** self.m
        E.check_operands("u", columns[0], lim, f"B^{self.m}")
        E.check_operands("v", columns[1], lim, f"B^{self.m}")
        return n

    def divide(self, us: list[int], vs: list[int]):
        """Exact (q, r) lists for batched u / v; v = 0 gives the total
        extension (q, r) = (0, u)."""
        n = self.validate("divmod", (us, vs))
        if n == 0:
            return [], []
        self.telemetry.record_request("divmod", n)
        qs, rs = [], []
        for lo, hi, bucket in self.batcher.plan(n):
            u = bi.limbs_from_numpy(bi.batch_from_ints(
                BT.pad_ints(us[lo:hi], bucket, 0), self.m), self.device)
            v = bi.limbs_from_numpy(bi.batch_from_ints(
                BT.pad_ints(vs[lo:hi], bucket, 1), self.m), self.device)
            self.telemetry.record_rows(bucket, hi - lo)
            with self.telemetry.chunk_timer("divmod", bucket):
                q, r = S.divmod_batch(u, v)
                q, r = bi.limbs_to_numpy(q), bi.limbs_to_numpy(r)
            keep = hi - lo
            qs += bi.batch_to_ints(q[:keep])
            rs += bi.batch_to_ints(r[:keep])
        return qs, rs

    def stats(self) -> dict:
        return self.telemetry.stats()
