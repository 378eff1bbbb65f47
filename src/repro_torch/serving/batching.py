"""Request batching for the port's services: kernel plans, bucket
planning, padding and runtime metrics (the port of `KernelPlan`,
`kernel_plan`, `Batcher`, `pad_ints`, `ServiceMetrics` and
`CompiledBuckets` from `repro/serving/batching.py`; JAX's
`resolve_impl` is `kernels/ops.py:check_impl`).

PyTorch runs eagerly and the kernels are built once per process
(`kernels/build.py`), so a bucket compiles nothing: a bucket is the
batch size a request chunk is padded to, and what a service builds on
the first use of an (op, bucket, impl) is its `KernelPlan`
(`PlanCache`).  The JAX plan's TPU grid fields (block_b, grid_rows,
grid_pairs, grid_scheduled, grid_steps, super_tile, revisit_passes)
have no counterpart here and are dropped.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

from repro_torch.kernels import ops as K
from repro_torch.obs import costmodel as CM
from repro_torch.obs import telemetry as T


class KernelPlan(NamedTuple):
    """What one (op, bucket, precision) runs on."""
    impl: str                  # resolved impl
    fused: bool = False        # division and Barrett glue run in-kernel
    step_launches: int = 0     # kernel launches per Refine iteration
    step_glue_ops: int = 0     # full-width torch glue ops per iteration
    mul_launches: int = 0      # kernel launches per standalone product
    degraded_from: str = ""    # the requested impl, when the serving
                               # ladder ran a fallback instead


def kernel_plan(impl: str | None = None) -> KernelPlan:
    """The plan of `impl`, from the cost model, so a plan never drifts
    from the launch counts the smoke run checks."""
    impl = K.check_impl(impl)
    return KernelPlan(impl, fused=impl == "cuda_fused",
                      step_launches=CM.step_launches(impl),
                      step_glue_ops=CM.step_glue_ops(impl),
                      mul_launches=CM.mul_launches(impl))


class PlanCache:
    """A service's kernel plans per (op, bucket, impl), built on first
    use, and the plan each bucket ran last (`current`).

    `use` builds a plan only on a miss, under one lock, so racing first
    uses build once; `on_build` (the service's compile fault site) runs
    before the build, and a miss that raises caches nothing (the next
    request tries again).  `hits`/`misses` count the lookups."""

    def __init__(self):
        self._plans: dict[tuple, KernelPlan] = {}
        self._lock = threading.RLock()
        self.current: dict[int, KernelPlan] = {}
        self.hits = 0
        self.misses = 0

    def use(self, op: str, bucket: int, impl: str, requested: str,
            on_build) -> KernelPlan:
        """The plan of (op, bucket, impl); recorded as the bucket's
        current plan, with `degraded_from` set when impl is not the
        `requested` one (the serving ladder ran a fallback)."""
        key = (op, bucket, impl)
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                self.misses += 1
                on_build(op=op, bucket=bucket, impl=impl)
                plan = self._plans[key] = kernel_plan(impl)
            else:
                self.hits += 1
            self.current[bucket] = plan._replace(
                degraded_from=requested if impl != requested else "")
            return plan


class Batcher:
    """Plans how a request of size n maps onto bucket sizes.

    Oversized requests are split into largest-bucket chunks; the final
    partial chunk gets the smallest bucket that fits it.
    """

    def __init__(self, buckets=(64, 256, 1024)):
        if not buckets:
            raise ValueError("need at least one batch bucket")
        self.buckets = tuple(sorted(buckets))

    def bucket_for(self, n: int) -> int:
        return next((b for b in self.buckets if b >= n), self.buckets[-1])

    def plan(self, n: int) -> list[tuple[int, int, int]]:
        """[(lo, hi, bucket)] chunks covering range(n); an empty request
        plans no chunks."""
        if n <= 0:
            return []
        big = self.buckets[-1]
        out, i = [], 0
        while n - i > big:
            out.append((i, i + big, big))
            i += big
        out.append((i, n, self.bucket_for(n - i)))
        return out


def pad_ints(xs, bucket: int, fill: int) -> list:
    """Pad a request column to the bucket size with a benign fill."""
    return list(xs) + [fill] * (bucket - len(xs))


class ServiceMetrics:
    """A service's runtime metric families on one `telemetry.Registry`:
    requests and rows per op, true and padded rows per bucket, and
    per-(op, bucket) execution wall time.  `stats()` has the keys of the
    JAX package's ServiceMetrics.  A lock makes the recording safe from
    several threads."""

    def __init__(self):
        self.registry = T.Registry()
        self._lock = threading.Lock()
        self._requests = self.registry.counter(
            "requests_total", "service endpoint calls", ("op",))
        self._items = self.registry.counter(
            "items_total", "true (unpadded) request rows", ("op",))
        self._rows_true = self.registry.counter(
            "batch_rows_true_total", "true rows per bucket", ("bucket",))
        self._rows_padded = self.registry.counter(
            "batch_rows_padded_total", "bucket-padded rows submitted",
            ("bucket",))
        self._latency = self.registry.histogram(
            "bucket_seconds", "per-bucket execution wall time",
            ("op", "bucket"))

    def record_request(self, op: str, n_items: int) -> None:
        with self._lock:
            self._requests.labels(op=op).inc()
            self._items.labels(op=op).inc(n_items)

    def record_rows(self, bucket: int, true_rows: int) -> None:
        with self._lock:
            self._rows_true.labels(bucket=bucket).inc(true_rows)
            self._rows_padded.labels(bucket=bucket).inc(bucket)

    def record_seconds(self, op: str, bucket: int, seconds: float) -> None:
        with self._lock:
            self._latency.labels(op=op, bucket=bucket).observe(seconds)

    @contextmanager
    def chunk_timer(self, op: str, bucket: int):
        """Times one padded-bucket execution (host clock; the body must
        wait for the device)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record_seconds(op, bucket, time.perf_counter() - t0)

    def pad_waste(self) -> float:
        """(padded - true) / padded rows over the service lifetime."""
        with self._lock:
            padded = sum(s.value for s in self._rows_padded.series())
            true = sum(s.value for s in self._rows_true.series())
        return (padded - true) / padded if padded else 0.0

    def stats(self) -> dict:
        waste = self.pad_waste()
        with self._lock:
            return {
                "requests": {s.labels["op"]: int(s.value)
                             for s in self._requests.series()},
                "items": {s.labels["op"]: int(s.value)
                          for s in self._items.series()},
                "rows_true": int(sum(s.value
                                     for s in self._rows_true.series())),
                "rows_padded": int(sum(
                    s.value for s in self._rows_padded.series())),
                "pad_waste": waste,
                "bucket_seconds": {
                    f"{s.labels['op']}/b{s.labels['bucket']}":
                        {"count": s.count, "sum": s.value}
                    for s in self._latency.series()},
            }
