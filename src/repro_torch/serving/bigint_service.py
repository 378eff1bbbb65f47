"""Batched multi-precision division service on the card.

Requests are Python ints; the service validates them, packs each chunk
of a request into a bucket-sized (bucket, m_limbs) limb batch on the
host, runs `core.shinv.divmod_batch` with its impl on its device (or
sharded over a mesh's devices), and unpacks exact results.  The port of
`repro/serving/bigint_service.py`.

Each (bucket, impl) runs one executable (`batching.CompiledBuckets`),
built on its first use: on the card a CUDA graph of the whole division,
so a chunk is a copy into the graph's static inputs, one replay and a
copy out.  The build takes the bucket's static launch profile
(`static_profiles`; `profile_bucket` builds without a request) beside
its `KernelPlan` (`kernel_plans`), and `snapshot()` merges them with the
runtime counters every request records on `telemetry.registry`, for
`obs/report.py:render_measured_vs_model`.  The fault-injection sites of
serving/faults.py (compile, transfer, execute) fire when an injector is
installed.

Under `mesh=` (`launch/mesh.py:DeviceMesh`) each executable is a
`batching.ShardedExecutable`: the bucket's rows split equally over the
mesh's shards, each shard a graph of its own on its device.  The static
profile is one shard's (with `shards`), and the runtime launch counters
count every shard's replay.
"""

from __future__ import annotations

from functools import partial

import torch

from repro_torch.core import bigint as bi
from repro_torch.core import shinv as S
from repro_torch.kernels import ops as K
from repro_torch.obs import telemetry as T
from . import batching as BT
from . import errors as E


class BigintDivisionService:
    """Batched exact division at m_limbs limbs.

    impl:   the registry impl (`kernels/ops.py`; None = cuda_fused);
            `divide(..., impl=)` overrides it per call
    device: where the work runs ("cuda" needs a card; "cpu" runs the
            plain versions); on the card a width past the impl's
            shared-memory staging raises ValueError here
            (`core.shinv.check_width`)
    mesh:   an optional `launch/mesh.py:DeviceMesh` to shard each
            bucket's rows over (it replaces `device`: the work runs on
            the mesh's devices, gathered on its first); every bucket
            must split into equal shards (ValueError here)
    faults: an optional serving/faults.FaultInjector
    """

    def __init__(self, m_limbs: int, batch_buckets=(64, 256, 1024),
                 device="cuda", impl: str | None = None, faults=None,
                 mesh=None):
        self.m = m_limbs
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh else torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BigintDivisionService(device='cuda') needs "
                               "a CUDA device; pass device='cpu' to run "
                               "the plain versions on the CPU")
        self.impl = impl
        for dev in mesh.distinct if mesh else (self.device,):
            S.check_width(dev, m_limbs, impl)       # before any request
        BT.check_buckets(batch_buckets, mesh)
        self.batcher = BT.Batcher(batch_buckets)
        self.telemetry = BT.ServiceMetrics()
        self._fns = BT.CompiledBuckets()
        self.kernel_plans = self._fns.current       # bucket -> KernelPlan
        self.static_profiles: dict[int, dict] = {}  # bucket -> op -> profile
        self.faults = faults

    @property
    def buckets(self):
        return list(self.batcher.buckets)

    def set_fault_injector(self, faults) -> None:
        """Install (or clear, with None) a fault injector."""
        self.faults = faults

    def _fire(self, site: str, **labels) -> None:
        if self.faults is not None:
            self.faults.fire(site, **labels)

    def validate(self, op: str, columns, v=None) -> int:
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

    def _fill(self, device, rows: int):
        """pad_ints' fill (u = 0, v = 1) of `rows` rows on `device`."""
        u = torch.zeros(rows, self.m, dtype=bi.DTYPE, device=device)
        v = u.clone()
        v[:, 0] = 1
        return u, v

    def _fn(self, bucket: int, impl: str | None = None):
        """The (bucket, impl) executable, built on its first use (the
        compile fault site fires before the build)."""
        eff = K.check_impl(impl or self.impl)

        def build():
            exe = BT.sharded(partial(S.divmod_batch, impl=eff), self._fill,
                             BT.kernel_plan(eff), device=self.device,
                             mesh=self.mesh, bucket=bucket, batched=(0, 1))
            self.static_profiles.setdefault(bucket, {})["divmod"] = exe.static
            return exe
        return self._fns.use("divmod", bucket, eff, K.check_impl(self.impl),
                             build, partial(self._fire, "compile"))

    def profile_bucket(self, bucket: int) -> dict:
        """Build one bucket's executable without a request and return
        its static profiles ({op: profile})."""
        self._fn(bucket)
        return self.static_profiles.get(bucket, {})

    def divide(self, us: list[int], vs: list[int], *,
               impl: str | None = None):
        """Exact (q, r) lists for batched u / v; v = 0 gives the total
        extension (q, r) = (0, u).  `impl` overrides the service's impl
        for this call (the frontend's degradation ladder); every impl
        gives the same bits."""
        n = self.validate("divmod", (us, vs))
        if n == 0:
            return [], []
        eff = K.check_impl(impl or self.impl)
        self.telemetry.record_request("divmod", n)
        qs, rs = [], []
        for lo, hi, bucket in self.batcher.plan(n):
            self._fire("transfer", op="divmod", bucket=bucket)
            u = bi.limbs_from_numpy(bi.batch_from_ints(
                BT.pad_ints(us[lo:hi], bucket, 0), self.m), "cpu")
            v = bi.limbs_from_numpy(bi.batch_from_ints(
                BT.pad_ints(vs[lo:hi], bucket, 1), self.m), "cpu")
            fn = self._fn(bucket, eff)
            self.telemetry.record_rows(bucket, hi - lo)
            with T.annotate(f"bigint_service/divmod/b{bucket}"), \
                    self.telemetry.chunk_timer("divmod", bucket):
                self._fire("execute", op="divmod", bucket=bucket, impl=eff)
                q, r = fn(u, v)
                q, r = bi.limbs_to_numpy(q), bi.limbs_to_numpy(r)
            keep = hi - lo
            qs += bi.batch_to_ints(q[:keep])
            rs += bi.batch_to_ints(r[:keep])
        return qs, rs

    # -- introspection ----------------------------------------------------

    def stats(self) -> dict:
        """Runtime counters; `bucket_compiles` counts the (op, bucket,
        impl) executables built, `bucket_reuses` the later uses."""
        out = self.telemetry.stats()
        out["bucket_compiles"] = self._fns.misses
        out["bucket_reuses"] = self._fns.hits
        return out

    def snapshot(self) -> dict:
        """Merged static and runtime profile: per bucket the KernelPlan
        and the static launch profile, beside the runtime counters.
        Render with `obs/report.py:render_measured_vs_model`."""
        return {
            "service": "bigint_division",
            "m_limbs": self.m,
            "impl": K.check_impl(self.impl),
            "device": self.device.type,
            "shards": self.mesh.size if self.mesh else 1,
            "iters": S.refine_iters(self.m),
            "buckets": BT.snapshot_buckets(self.kernel_plans,
                                           self.static_profiles),
            "runtime": self.stats(),
        }
