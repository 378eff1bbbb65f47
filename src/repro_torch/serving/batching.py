"""Request batching for the port's services: kernel plans, compiled
bucket executables, bucket planning, padding and runtime metrics (the
port of `KernelPlan`, `kernel_plan`, `CompiledBuckets`, `Batcher`,
`pad_ints` and `ServiceMetrics` from `repro/serving/batching.py`; JAX's
`resolve_impl` is `kernels/ops.py:check_impl`).

A bucket is the batch size a request chunk is padded to.  What a
service builds on the first use of an (op, bucket, impl) is an
`Executable`, the counterpart of JAX's jitted per-bucket executable: on
the card one `torch.cuda.CUDAGraph` of the whole function, captured
after one eager warm-up call on the bucket's padding fill, so that a
call is one replay between a copy into the graph's static inputs and a
copy out of its static outputs; on the CPU the eager function itself.
The warm-up call also gives the bucket's static launch profile
(`utils/launch_stats.py:trace_profile`), as JAX takes its trace profile
when a bucket compiles.  The JAX plan's TPU grid fields (block_b,
grid_rows, grid_pairs, grid_scheduled, grid_steps, super_tile,
revisit_passes) have no counterpart here and are dropped.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ops as K
from repro_torch.obs import costmodel as CM
from repro_torch.obs import telemetry as T
from repro_torch.utils import launch_stats as LS


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


class Executable:
    """One (op, bucket, impl)'s compiled function: `fn` over tensors of
    the shapes of `fill` (the bucket's padding fill), with its
    `KernelPlan` and its static launch profile (`static`).

    On the card the build runs fn once eagerly on the fill, on a side
    stream (the warm-up, which `static` is taken on, and which makes
    the kernel libraries' first-use CUDA calls), then captures one
    call into a `torch.cuda.CUDAGraph` with its own memory pool, in
    thread-local capture mode.  `launches` are the kernel launches the
    graph recorded; every replay counts them
    (`kernels.build.count_all`).  A call copies its arguments (host or
    device tensors) into the graph's static inputs, replays and clones
    the static outputs, under a lock, so threads may share one
    executable; it runs on the caller's current stream.  A capture or
    a replay that fails raises; nothing stands in for the graph.

    On the CPU the executable is fn itself (nothing launches there, and
    `launches` is empty).  `capture_seconds`, `instantiate_seconds` and
    `memory_bytes` (the growth of `torch.cuda.memory_reserved` over the
    capture) describe the build on the card and are None on the CPU."""

    def __init__(self, fn, fill, plan: KernelPlan):
        self.plan = plan
        self.device = fill[0].device
        self.launches: dict[str, int] = {}
        self.graph = None
        self.capture_seconds = self.instantiate_seconds = None
        self.memory_bytes = None
        self._fn = fn
        self._lock = threading.Lock()
        if self.device.type != "cuda":
            self.static = LS.trace_profile(fn, *fill)
            return
        self.inputs = [t.clone() for t in fill]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.static = LS.trace_profile(fn, *self.inputs)
        # the capture empties the allocator's cache as it starts: empty
        # it first, so that the growth below is the graph's own pool
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        mem = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with build.recording(capture=True) as self.launches, \
                torch.cuda.graph(graph, stream=side,
                                 capture_error_mode="thread_local"):
            out = fn(*self.inputs)
        t1 = time.perf_counter()
        graph.instantiate()
        self.instantiate_seconds = time.perf_counter() - t1
        self.capture_seconds = t1 - t0
        self.memory_bytes = torch.cuda.memory_reserved(self.device) - mem
        self._single = isinstance(out, torch.Tensor)
        self.outputs = (out,) if self._single else tuple(out)
        self.graph = graph

    def __call__(self, *args):
        if self.graph is None:
            return self._fn(*args)
        if len(args) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} arguments, got "
                             f"{len(args)}")
        for dst, src in zip(self.inputs, args):
            if src.shape != dst.shape:
                raise ValueError(f"argument of shape {tuple(src.shape)}, "
                                 f"expected {tuple(dst.shape)}")
        with self._lock:
            for dst, src in zip(self.inputs, args):
                dst.copy_(src)
            self.graph.replay()
            build.count_all(self.launches)
            out = tuple(o.clone() for o in self.outputs)
        return out[0] if self._single else out


class CompiledBuckets:
    """A service's executables per (op, bucket, impl), built on first
    use, and the plan each bucket ran last (`current`).

    `use` builds only on a miss, under one RLock held across the check
    and the build, so racing first uses build once (this serializes
    first builds of different buckets too; steady traffic is all
    hits).  `on_build` (the service's compile fault site) runs on a
    miss before the build, and a build that raises caches nothing (the
    next request tries again).  `hits`/`misses` count the lookups."""

    def __init__(self):
        self._fns: dict[tuple, Executable] = {}
        self._lock = threading.RLock()
        self.current: dict[int, KernelPlan] = {}
        self.hits = 0
        self.misses = 0

    def use(self, op: str, bucket: int, impl: str, requested: str, build,
            on_build=None) -> Executable:
        """The executable of (op, bucket, impl), `build()` on a miss;
        its plan is recorded as the bucket's current plan, with
        `degraded_from` set when impl is not the `requested` one (the
        serving ladder ran a fallback)."""
        key = (op, bucket, impl)
        with self._lock:
            exe = self._fns.get(key)
            if exe is None:
                self.misses += 1
                if on_build is not None:
                    on_build(op=op, bucket=bucket, impl=impl)
                exe = self._fns[key] = build()
            else:
                self.hits += 1
            self.current[bucket] = exe.plan._replace(
                degraded_from=requested if impl != requested else "")
            return exe

    def __len__(self) -> int:
        with self._lock:
            return len(self._fns)


def snapshot_buckets(plans: dict, static: dict) -> dict:
    """A service snapshot's "buckets": per bucket its current KernelPlan
    (as a dict) and its static profiles per op, where it has them."""
    out = {}
    for b in sorted(set(plans) | set(static)):
        entry = {}
        if b in plans:
            entry["plan"] = plans[b]._asdict()
        if b in static:
            entry["static"] = dict(static[b])
        out[b] = entry
    return out


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
