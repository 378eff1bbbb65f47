"""Request batching for the port's services: kernel plans, compiled
bucket executables and their sharding over a device mesh, bucket
planning, padding and runtime metrics (the port of `KernelPlan`,
`kernel_plan`, `CompiledBuckets`, `sharded_jit`, `Batcher`, `pad_ints`
and `ServiceMetrics` from `repro/serving/batching.py`; `resolve_impl`
is `kernels/ops.py:check_impl`).

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

Under a mesh (`launch/mesh.py:DeviceMesh`) a bucket's executable is a
`ShardedExecutable`: one `Executable` per shard on the shard's device,
the bucket's rows split equally over them and the rest replicated, as
JAX's `sharded_jit` shards the batch axis and replicates the context.
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


resolve_impl = K.check_impl


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
        # build with the executable's card current: the side stream's
        # context switches the device too, but only inside it, and the
        # synchronize, the cache and the graph's pool below are that
        # card's as well
        with torch.cuda.device(self.device):
            self._build(fn, fill)

    def _build(self, fn, fill):
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


class ShardedExecutable:
    """One (op, bucket, impl)'s executable over a `DeviceMesh`: an
    `Executable` per shard, built on the shard's device over
    bucket / shards rows, the counterpart of JAX's `sharded_jit`.

    Each shard's Executable runs fn over `fill(device, rows)`.  A call
    splits the arguments at `batched` (indices) on rows into equal shards, in
    mesh order; every other argument is replicated: a dict {device:
    tensor} gives each shard its own device's copy (the modular
    service's cached context, copied to each device once), a tensor is
    given to every shard as it is.  The shards are launched one after
    another without a host sync, each from its own stream made current
    on its device (each Executable runs on the caller's current
    stream), and their outputs gathered in row order on the first
    shard's device once the caller's stream there has waited on every
    shard's.  Each shard's replay counts its own launches, so a call
    counts shards x the per-shard model.  On the CPU the shards run in
    turn.

    `static` is one shard's static profile with `shards` (every shard
    traces the same program), `launches` one shard's recorded
    launches."""

    def __init__(self, fn, fill, plan: KernelPlan, mesh, bucket: int,
                 batched: tuple):
        check_buckets((bucket,), mesh)
        self.mesh = mesh
        self.rows = bucket // mesh.size
        self.batched = frozenset(batched)
        self.shards = [Executable(fn, fill(dev, self.rows), plan)
                       for dev in mesh.devices]
        self.plan, self.device = plan, mesh.devices[0]
        self.launches = self.shards[0].launches
        self.static = dict(self.shards[0].static, shards=mesh.size)
        self._cuda = self.device.type == "cuda"
        self._streams = [torch.cuda.Stream(d) if self._cuda else None
                         for d in mesh.devices]

    def _shard_args(self, i: int, args) -> list:
        dev, lo = self.mesh.devices[i], i * self.rows
        out = []
        for j, a in enumerate(args):
            if j in self.batched:
                out.append(a[lo:lo + self.rows])
            else:
                out.append(a[dev] if isinstance(a, dict) else a)
        return out

    def __call__(self, *args):
        for j in self.batched:
            if args[j].shape[0] != self.rows * self.mesh.size:
                raise ValueError(f"argument {j} has {args[j].shape[0]} "
                                 f"rows, expected "
                                 f"{self.rows * self.mesh.size}")
        if not self._cuda:
            outs = [exe(*self._shard_args(i, args))
                    for i, exe in enumerate(self.shards)]
            return self._gather(outs)
        callers = {d: torch.cuda.current_stream(d)
                   for d in self.mesh.distinct}
        outs = []
        for i, (exe, stream) in enumerate(zip(self.shards, self._streams)):
            dev = self.mesh.devices[i]
            stream.wait_stream(callers[dev])
            with torch.cuda.stream(stream):
                outs.append(exe(*self._shard_args(i, args)))
        for i, (out, stream) in enumerate(zip(outs, self._streams)):
            caller = callers[self.mesh.devices[i]]
            caller.wait_stream(stream)
            for t in (out,) if isinstance(out, torch.Tensor) else out:
                t.record_stream(caller)
        return self._gather(outs)

    def _gather(self, outs):
        dev = self.device
        if isinstance(outs[0], torch.Tensor):
            return torch.cat([o.to(dev) for o in outs])
        return tuple(torch.cat([o[k].to(dev) for o in outs])
                     for k in range(len(outs[0])))


def sharded(fn, fill, plan: KernelPlan, *, device, mesh=None,
            bucket: int, batched: tuple):
    """The bucket's executable: without a mesh one `Executable` on
    `device` over `fill(device, bucket)`; under a mesh a
    `ShardedExecutable` of one per shard over `fill(device, rows)` (the
    counterpart of JAX's `sharded_jit`).  Raises ValueError where the
    mesh's shard count does not divide the bucket."""
    if mesh is None:
        return Executable(fn, fill(device, bucket), plan)
    return ShardedExecutable(fn, fill, plan, mesh, bucket, batched)


def check_buckets(buckets, mesh) -> None:
    """Raise ValueError for a bucket the mesh's shard count does not
    divide (JAX raises on it when the bucket compiles)."""
    if mesh is None:
        return
    bad = [b for b in buckets if b % mesh.size]
    if bad:
        raise ValueError(f"batch buckets {bad} do not split into "
                         f"{mesh.size} equal shards")


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
