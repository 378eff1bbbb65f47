"""Fault-tolerant async continuous-batching serving frontend.

The port's copy of `repro/serving/frontend.py`.  `AsyncFrontend` wraps
one service (`BigintDivisionService` or `ModArithService`) with:

  admission   `submit` sheds load with a typed `Overloaded` when the
              queue depth or the queued rows exceed policy, before
              anything is enqueued.
  coalescing  one consumer drains arrivals each cycle and merges
              same-(op, modulus) requests into shared bucket chunks
              (`Batcher.plan` over the concatenated rows).
  deadlines   per request, checked at every chunk boundary (a running
              kernel is not preempted); chunks not yet submitted are
              cancelled, and `DeadlineExceeded` carries the completed
              and total rows.
  retry       transient faults (serving/errors.py) re-run the chunk with
              capped exponential backoff and seeded jitter.
  degradation kernel faults (injected ones: a real launch failure or
              CUDA out of memory is fatal) open a circuit breaker on
              that (impl, bucket, precision), and the chunk falls down
              the registry ladder (`kernels/ops.py:fallback_chain`:
              cuda_fused -> cuda_batched -> blocked, cuda_pairs ->
              blocked; a service on the card stops before blocked).
              Every impl gives the same bits, so degradation shows only
              in `KernelPlan.degraded_from`, the `degraded_total`
              counter and the healthz quarantine set.  Half-open probes
              retry a quarantined kernel after a cooldown.
  health      `healthz()` / `ready()` give queue depth, quarantine set,
              breaker states and drop accounting; `snapshot()` merges
              the frontend's registry, the service's snapshot and the
              fault injector's accounting.

Determinism: the frontend adds no randomness beyond the seeded backoff
jitter, so with a seeded fault plan (serving/faults.py) a whole chaos
run (which faults fire, which retries happen, which impls quarantine)
is reproducible.

Compute runs on one worker thread of the frontend's own (one chunk at
a time: the services' tensors stay on their device, and the card runs
one stream), so the event loop stays free for admissions and deadlines.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import random
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

from repro_torch.kernels import ops as K
from repro_torch.obs import telemetry as T
from . import errors as E
from .policy import KernelLadder, ServingPolicy, backoff_delay

# op -> (service method, request columns, result columns)
_OPS = {
    "divmod": ("divide", 2, 2),
    "reduce": ("reduce", 1, 1),
    "modmul": ("modmul", 2, 1),
    "modexp": ("modexp", 2, 1),
}

# hard bound on per-chunk attempts: every transient retry, ladder
# step, and half-open probe is counted by policy, but a bug in that
# accounting must never spin the worker
_MAX_CHUNK_ATTEMPTS = 64


class FrontendMetrics:
    """Queue and failure metric families of the async tier, on one
    Registry (uniform with `batching.ServiceMetrics`)."""

    def __init__(self):
        self.registry = T.Registry()
        r = self.registry
        self.queue_depth = r.gauge(
            "queue_depth", "admitted requests not yet finished")
        self.queued_items = r.gauge(
            "queued_items", "admitted rows not yet computed")
        self.admitted = r.counter(
            "admitted_total", "requests accepted into the queue",
            ("op",))
        self.rejected = r.counter(
            "rejected_total", "requests shed at admission", ("reason",))
        self.completed = r.counter(
            "completed_total", "requests resolved successfully", ("op",))
        self.failed = r.counter(
            "failed_total", "requests resolved with an error",
            ("op", "kind"))
        self.faults = r.counter(
            "faults_total", "chunk execution faults observed",
            ("op", "kind"))
        self.retries = r.counter(
            "retries_total", "transient-fault chunk retries", ("op",))
        self.degraded = r.counter(
            "degraded_total", "chunk executions routed down the ladder",
            ("from_impl", "to_impl"))
        self.deadline_exceeded = r.counter(
            "deadline_exceeded_total", "requests expired by deadline",
            ("op",))
        self.chunks_cancelled = r.counter(
            "chunks_cancelled_total",
            "chunks skipped because every member request had expired")
        self.batches = r.counter(
            "batches_total", "coalescing cycles executed")
        self.coalesced = r.histogram(
            "coalesced_requests", "requests merged per batch cycle",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128))
        self.request_seconds = r.histogram(
            "request_seconds", "admission-to-resolution wall time",
            ("op",))


class _Request:
    """One admitted request and its scatter/accounting state."""

    __slots__ = ("id", "op", "cols", "v", "n", "nout", "deadline",
                 "future", "done_items", "results", "settled")

    def __init__(self, rid, op, cols, v, nout, deadline, future):
        self.id = rid
        self.op = op
        self.cols = cols
        self.v = v
        self.n = len(cols[0])
        self.nout = nout
        self.deadline = deadline
        self.future = future
        self.done_items = 0
        self.results = [[None] * self.n for _ in range(nout)]
        self.settled = False       # accounting resolved exactly once


class AsyncFrontend:
    """Async continuous-batching frontend over one sync service.

    service: a `BigintDivisionService` or `ModArithService` (anything
             with `batcher`, `m`, `impl`, `validate`, and the op
             methods accepting an `impl=` override)
    policy:  `ServingPolicy` (admission, retry, breaker knobs)
    faults:  optional `FaultInjector`, installed into the service
    clock:   injectable monotonic clock (deadlines + breakers)
    """

    def __init__(self, service, *, policy: ServingPolicy | None = None,
                 faults=None, clock=time.monotonic):
        self.service = service
        self.policy = policy or ServingPolicy()
        self.clock = clock
        self.faults = faults
        if faults is not None:
            service.set_fault_injector(faults)
        self.metrics = FrontendMetrics()
        self.ladder = KernelLadder(self.policy, clock=clock,
                                   device=service.device)
        self._queue: asyncio.Queue | None = None
        self._worker: asyncio.Task | None = None
        self._pool: ThreadPoolExecutor | None = None
        self._accepting = False
        self._ids = itertools.count()
        self._rng = random.Random(self.policy.retry_seed)
        self._depth = 0           # admitted, not yet resolved
        self._items = 0           # admitted rows, not yet computed

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        if self._worker is not None and not self._worker.done():
            raise RuntimeError("frontend already started")
        self._queue = asyncio.Queue()
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="frontend")
        self._accepting = True
        self._worker = asyncio.create_task(self._serve_loop())

    async def stop(self, drain: bool = True) -> None:
        """Stop accepting; by default drain in-flight work first.
        With drain=False, queued requests fail with RequestCancelled."""
        self._accepting = False
        if drain:
            while self._depth > 0 and not (self._worker is None
                                           or self._worker.done()):
                await asyncio.sleep(0.002)
        if self._worker is not None:
            self._worker.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._worker
            self._worker = None
        if self._queue is not None:
            while True:
                try:
                    req = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                self._fail(req, E.RequestCancelled(
                    f"frontend stopped before request {req.id} ran"))
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.stop()

    # -- admission --------------------------------------------------------

    async def submit(self, op: str, *cols, v: int | None = None,
                     timeout: float | None = None):
        """Submit one request; resolves to the same value the sync
        service method returns ((qs, rs) for divmod, a list
        otherwise).  Raises: InvalidRequest subtypes synchronously,
        Overloaded at admission, DeadlineExceeded on expiry, or the
        terminal chunk error."""
        try:
            spec = _OPS.get(op)
            if spec is None:
                raise E.InvalidRequest(
                    f"unknown op {op!r}; expected one of {sorted(_OPS)}")
            _, ncols, nout = spec
            if len(cols) != ncols:
                raise E.InvalidRequest(
                    f"{op} takes {ncols} columns, got {len(cols)}")
            if op != "divmod" and v is None:
                raise E.InvalidRequest(f"{op} requires a modulus v")
            cols = tuple(list(c) for c in cols)
            n = self.service.validate(op, cols, v)
        except E.InvalidRequest:
            self.metrics.rejected.labels(reason="invalid").inc()
            raise
        if n == 0:
            return ([], []) if nout == 2 else []
        if not self._accepting or self._queue is None:
            self.metrics.rejected.labels(reason="stopped").inc()
            raise E.Overloaded("frontend is not accepting requests",
                               reason="stopped")
        if self._depth >= self.policy.max_queue_depth:
            self.metrics.rejected.labels(reason="queue_depth").inc()
            raise E.Overloaded(reason="queue_depth",
                               depth=self._depth,
                               limit=self.policy.max_queue_depth)
        if self._items + n > self.policy.max_queued_items:
            self.metrics.rejected.labels(reason="queued_work").inc()
            raise E.Overloaded(reason="queued_work",
                               depth=self._items + n,
                               limit=self.policy.max_queued_items)
        timeout = timeout if timeout is not None \
            else self.policy.default_timeout
        deadline = None if timeout is None else self.clock() + timeout
        req = _Request(next(self._ids), op, cols, v, nout, deadline,
                       asyncio.get_running_loop().create_future())
        self._depth += 1
        self._items += n
        self._set_gauges()
        self.metrics.admitted.labels(op=op).inc()
        await self._queue.put(req)
        with self.metrics.request_seconds.labels(op=op).time():
            return await req.future

    def _set_gauges(self) -> None:
        self.metrics.queue_depth.set(self._depth)
        self.metrics.queued_items.set(self._items)

    # -- batch loop -------------------------------------------------------

    async def _serve_loop(self) -> None:
        assert self._queue is not None
        while True:
            req = await self._queue.get()
            if self.policy.coalesce_window > 0:
                await asyncio.sleep(self.policy.coalesce_window)
            batch = [req]
            while len(batch) < self.policy.max_batch_requests:
                try:
                    batch.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            self.metrics.batches.inc()
            self.metrics.coalesced.observe(len(batch))
            # group same-(op, modulus) requests into shared chunks
            groups: dict[tuple, list[_Request]] = {}
            for r in batch:
                groups.setdefault((r.op, r.v), []).append(r)
            for (op, v), members in groups.items():
                try:
                    await self._run_group(op, v, members)
                except Exception as exc:      # never kill the worker
                    for r in members:
                        self._fail(r, exc)

    async def _run_group(self, op: str, v, members: list[_Request]):
        # concatenate member columns; remember each member's segment
        ncols = len(members[0].cols)
        cols = [[] for _ in range(ncols)]
        segments = []                          # (req, global lo)
        total = 0
        for r in members:
            segments.append((r, total))
            for c in range(ncols):
                cols[c].extend(r.cols[c])
            total += r.n
        for clo, chi, bucket in self.service.batcher.plan(total):
            live = self._live_members(segments, clo, chi)
            if not live:
                self.metrics.chunks_cancelled.inc()
                continue
            chunk_cols = [c[clo:chi] for c in cols]
            try:
                out = await self._execute_chunk(op, v, chunk_cols,
                                                bucket, segments,
                                                clo, chi)
            except Exception as exc:
                for r, _ in self._live_members(segments, clo, chi):
                    self._fail(r, exc)
                continue
            if out is None:                    # every member expired
                continue
            self._scatter(out, segments, clo, chi)

    def _live_members(self, segments, clo, chi):
        """Members overlapping [clo, chi) that are still undecided,
        after cooperatively expiring any whose deadline passed (and
        settling any whose caller abandoned the future)."""
        now = self.clock()
        live = []
        for r, glo in segments:
            if glo >= chi or glo + r.n <= clo or r.settled:
                continue
            if r.future.done():        # caller cancelled the await
                self._settle(r)
                self.metrics.failed.labels(op=r.op,
                                           kind="cancelled").inc()
                self._set_gauges()
                continue
            if r.deadline is not None and now >= r.deadline:
                self._fail(r, E.DeadlineExceeded(
                    op=r.op, completed=r.done_items, total=r.n))
                continue
            live.append((r, glo))
        return live

    async def _execute_chunk(self, op, v, chunk_cols, bucket,
                             segments, clo, chi):
        """Run one padded-bucket chunk with retry, backoff, and
        ladder degradation.  Returns the service result tuple, None
        when every member expired mid-retry, or raises the terminal
        error."""
        requested = K.check_impl(self.service.impl)
        m = self.service.m
        loop = asyncio.get_running_loop()
        attempt = 0
        last_exc = None
        for _ in range(_MAX_CHUNK_ATTEMPTS):
            if not self._live_members(segments, clo, chi):
                self.metrics.chunks_cancelled.inc()
                return None
            eff = self.ladder.select(requested, bucket, m)
            if eff is None:
                raise last_exc if last_exc is not None else \
                    E.ServingError("every kernel impl is quarantined")
            if eff != requested:
                self.metrics.degraded.labels(
                    from_impl=requested, to_impl=eff).inc()
            try:
                out = await loop.run_in_executor(
                    self._pool, partial(self._call_service, op, v,
                                        chunk_cols, eff))
                self.ladder.record_success(eff, bucket, m)
                return out
            except Exception as exc:
                kind = E.classify(exc)
                self.metrics.faults.labels(op=op, kind=kind).inc()
                last_exc = exc
                if kind == "transient":
                    # says nothing about the kernel: hand back any
                    # half-open probe slot select() may have taken
                    self.ladder.release_probe(eff, bucket, m)
                    if attempt >= self.policy.max_retries:
                        raise
                    attempt += 1
                    self.metrics.retries.labels(op=op).inc()
                    await asyncio.sleep(
                        backoff_delay(self.policy, attempt, self._rng))
                    continue
                if kind == "kernel":
                    self.ladder.record_failure(eff, bucket, m)
                    continue          # next loop selects the fallback
                raise
        raise last_exc if last_exc is not None else \
            E.ServingError("chunk attempt budget exhausted")

    def _call_service(self, op, v, chunk_cols, impl):
        """Runs on the worker thread.  Returns a tuple of result
        columns, each len(chunk)."""
        meth = getattr(self.service, _OPS[op][0], None)
        if meth is None:
            raise E.InvalidRequest(
                f"service {type(self.service).__name__} does not "
                f"serve {op!r}")
        if op == "divmod":
            return meth(chunk_cols[0], chunk_cols[1], impl=impl)
        return (meth(*chunk_cols, v, impl=impl),)

    def _scatter(self, out, segments, clo, chi) -> None:
        """Deliver one chunk's result rows to the member requests and
        resolve any member that just completed."""
        for r, glo in segments:
            lo = max(glo, clo)
            hi = min(glo + r.n, chi)
            if lo >= hi or r.settled:
                continue
            for c in range(r.nout):
                r.results[c][lo - glo:hi - glo] = \
                    out[c][lo - clo:hi - clo]
            r.done_items += hi - lo
            self._items -= hi - lo
            if r.done_items == r.n:
                self._finish(r)
        self._set_gauges()

    # -- resolution -------------------------------------------------------

    def _settle(self, req: _Request) -> bool:
        """Resolve the depth/items accounting for `req` exactly once;
        returns False when another path already settled it."""
        if req.settled:
            return False
        req.settled = True
        self._depth -= 1
        self._items -= req.n - req.done_items
        return True

    def _finish(self, req: _Request) -> None:
        if not self._settle(req):
            return
        if not req.future.done():
            req.future.set_result(tuple(req.results) if req.nout == 2
                                  else req.results[0])
        self.metrics.completed.labels(op=req.op).inc()
        self._set_gauges()

    def _fail(self, req: _Request, exc: Exception) -> None:
        if not self._settle(req):
            return
        if not req.future.done():
            req.future.set_exception(exc)
        kind = E.classify(exc)
        self.metrics.failed.labels(op=req.op, kind=kind).inc()
        if kind == "deadline":
            self.metrics.deadline_exceeded.labels(op=req.op).inc()
        self._set_gauges()

    # -- health / observability -------------------------------------------

    def _counter_total(self, metric) -> int:
        return int(sum(s.value for s in metric.series()))

    def dropped_requests(self) -> int:
        """Admitted requests that never reached a terminal outcome
        (success or typed failure).  The robustness contract is that
        this stays 0: every admitted request is answered."""
        m = self.metrics
        return (self._counter_total(m.admitted)
                - self._counter_total(m.completed)
                - self._counter_total(m.failed)
                - self._depth)      # still queued/in flight, not dropped

    def healthz(self) -> dict:
        """Liveness, load and degradation."""
        m = self.metrics
        quarantine = self.ladder.quarantined()
        if not self._accepting:
            status = "stopped"
        elif self._depth >= self.policy.max_queue_depth:
            status = "overloaded"
        elif quarantine:
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "accepting": self._accepting,
            "ready": self.ready(),
            "queue_depth": self._depth,
            "queued_items": self._items,
            "quarantine": quarantine,
            "breakers": self.ladder.states(),
            "retries": self._counter_total(m.retries),
            "deadline_exceeded": self._counter_total(
                m.deadline_exceeded),
            "dropped": self.dropped_requests(),
        }

    def ready(self) -> bool:
        """Readiness: accepting, worker alive, queue below the
        admission ceiling."""
        return (self._accepting
                and self._worker is not None
                and not self._worker.done()
                and self._depth < self.policy.max_queue_depth)

    def snapshot(self) -> dict:
        """Merged frontend + wrapped-service + fault-injection view
        (the service part is the same snapshot the sync path
        exposes, including per-bucket KernelPlans with any
        `degraded_from` records)."""
        out = {
            "frontend": {
                "health": self.healthz(),
                "metrics": self.metrics.registry.collect(),
            },
            "service": self.service.snapshot(),
        }
        if self.faults is not None:
            out["faults"] = self.faults.stats()
        return out

    def metrics_lines(self) -> list[str]:
        """One line-protocol export across the frontend's queue/
        failure families and the wrapped service's request families."""
        return T.merged_lines(self.metrics.registry,
                              self.service.telemetry.registry)
