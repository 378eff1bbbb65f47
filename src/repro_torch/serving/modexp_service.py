"""Modular-arithmetic service on cached Barrett contexts, on the card.

`ModArithService` keeps a bounded LRU cache of per-modulus
`BarrettContext`s on its device (one Newton-iterated shinv each) and
serves `reduce`, `modmul` and `modexp` over Python-int requests.  The
first request against a modulus pays the precompute; every later
request, and every step of a modexp ladder, reuses the cached shifted
inverse.  Requests are validated, split into bucket-sized chunks and
padded as in `BigintDivisionService`, with the same impl overrides,
kernel plans and fault-injection sites (plus precompute).  The port of
`repro/serving/modexp_service.py` without trace profiles or a mesh.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from functools import partial

import torch

from repro_torch.core import bigint as bi
from repro_torch.core import modarith as MA
from repro_torch.kernels import ops as K
from repro_torch.obs import telemetry as T
from . import batching as BT
from . import errors as E


class ModArithService:
    """Batched modular arithmetic at one modulus storage width.

    m_limbs:    storage width of moduli and residues (values < B^m_limbs)
    e_limbs:    storage width of modexp exponents (default m_limbs)
    window_bits: modexp ladder window (must divide 16)
    max_cached_moduli: LRU bound on the contexts kept on the device
    device:     where the contexts live and the work runs ("cuda" needs
                a card; "cpu" runs the plain versions)
    impl:       the registry impl (`kernels/ops.py`; None = cuda_fused);
                each endpoint's `impl=` overrides it per call.  The
                precompute runs with the service's impl.
    faults:     an optional serving/faults.FaultInjector
    """

    def __init__(self, m_limbs: int, e_limbs: int | None = None,
                 window_bits: int = 4, batch_buckets=(64, 256, 1024),
                 max_cached_moduli: int = 64, device="cuda",
                 impl: str | None = None, faults=None):
        self.m = m_limbs
        self.e_limbs = e_limbs if e_limbs is not None else m_limbs
        self.window_bits = window_bits
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ModArithService(device='cuda') needs a "
                               "CUDA device; pass device='cpu' to run the "
                               "plain versions on the CPU")
        self.impl = impl
        K.check_impl(impl)
        self.batcher = BT.Batcher(batch_buckets)
        self.telemetry = BT.ServiceMetrics()
        self._ctx_metric = self.telemetry.registry.counter(
            "ctx_cache_total", "Barrett context cache events", ("event",))
        self._plans = BT.PlanCache()
        self.kernel_plans = self._plans.current     # bucket -> KernelPlan
        self.faults = faults
        self._ctxs: OrderedDict[int, MA.BarrettContext] = OrderedDict()
        self._ctx_lock = threading.RLock()
        self.max_cached = max_cached_moduli
        self.ctx_hits = 0
        self.ctx_misses = 0
        self.ctx_evictions = 0

    def set_fault_injector(self, faults) -> None:
        """Install (or clear, with None) a fault injector."""
        self.faults = faults

    def _fire(self, site: str, **labels) -> None:
        if self.faults is not None:
            self.faults.fire(site, **labels)

    # -- per-modulus context cache ----------------------------------------

    def check_modulus(self, v) -> None:
        if isinstance(v, bool) or not isinstance(v, int):
            raise E.OperandTypeError(
                f"modulus: expected int, got {type(v).__name__}")
        if v <= 0:
            raise E.InvalidRequest("modulus must be positive")
        if v >= bi.BASE ** self.m:
            raise E.OperandRangeError(
                f"modulus does not fit in {self.m} limbs")

    def context(self, v: int) -> MA.BarrettContext:
        """The Barrett context for v on the service's device, LRU-cached.
        The lock covers lookup, precompute, insert and eviction, so
        concurrent requests against one modulus precompute it once."""
        self.check_modulus(v)
        with self._ctx_lock:
            if v in self._ctxs:
                self._ctxs.move_to_end(v)
                self.ctx_hits += 1
                self._ctx_metric.labels(event="hit").inc()
                return self._ctxs[v]
            self._fire("precompute")
            self.ctx_misses += 1
            self._ctx_metric.labels(event="miss").inc()
            with T.annotate("modexp_service/precompute"):
                ctx = MA.barrett_precompute(
                    bi.limbs_from_numpy(bi.from_int(v, self.m), self.device),
                    self.impl)
            self._ctxs[v] = ctx
            while len(self._ctxs) > self.max_cached:
                self._ctxs.popitem(last=False)
                self.ctx_evictions += 1
                self._ctx_metric.labels(event="eviction").inc()
            return ctx

    # -- validation ---------------------------------------------------------

    def _op_schema(self, op: str):
        """(column name, limit, limit as text) per column of op; an
        exponent is bounded by e_limbs, not by the modulus width."""
        lim = bi.BASE ** self.m
        if op == "reduce":
            return (("x", bi.BASE ** (2 * self.m), f"B^{2 * self.m}"),)
        if op == "modmul":
            return (("a", lim, f"B^{self.m}"), ("b", lim, f"B^{self.m}"))
        if op == "modexp":
            return (("a", lim, f"B^{self.m}"),
                    ("e", bi.BASE ** self.e_limbs, f"B^{self.e_limbs}"))
        raise E.InvalidRequest(f"unknown op {op!r} for ModArithService")

    def validate(self, op: str, columns, v=None) -> int:
        """Full request validation (types, ranges, column lengths,
        modulus); returns the request length."""
        schema = self._op_schema(op)
        if len(columns) != len(schema):
            raise E.InvalidRequest(
                f"{op} takes {len(schema)} columns, got {len(columns)}")
        n = E.check_lengths(columns, names=[s[0] for s in schema])
        for col, (name, lim, what) in zip(columns, schema):
            E.check_operands(name, col, lim, what)
        if v is not None:
            self.check_modulus(v)
        return n

    # -- execution ------------------------------------------------------------

    def _run(self, op: str, fn, v: int, columns, widths, *,
             impl: str | None = None) -> list[int]:
        """Pack the int columns into limb batches per bucket, run
        fn(ctx, *arrays, impl) with the modulus's context, unpack.
        `impl` overrides the service's impl for this call (the
        frontend's degradation ladder; every impl gives the same
        bits)."""
        n = self.validate(op, columns, v)
        if n == 0:
            return []
        eff = K.check_impl(impl or self.impl)
        self.telemetry.record_request(op, n)
        ctx = self.context(v)
        out: list[int] = []
        for lo, hi, bucket in self.batcher.plan(n):
            self._fire("transfer", op=op, bucket=bucket)
            arrs = [bi.limbs_from_numpy(bi.batch_from_ints(
                        BT.pad_ints(col[lo:hi], bucket, 0), w), self.device)
                    for col, w in zip(columns, widths)]
            plan = self._plans.use(op, bucket, eff,
                                   K.check_impl(self.impl),
                                   partial(self._fire, "compile"))
            self.telemetry.record_rows(bucket, hi - lo)
            with T.annotate(f"modexp_service/{op}/b{bucket}"), \
                    self.telemetry.chunk_timer(op, bucket):
                self._fire("execute", op=op, bucket=bucket, impl=eff)
                res = bi.limbs_to_numpy(fn(ctx, *arrs, plan.impl))
            out += bi.batch_to_ints(res[:hi - lo])
        return out

    def reduce(self, xs: list[int], v: int, *,
               impl: str | None = None) -> list[int]:
        """[x mod v] for double-width x (x < B^(2 m_limbs))."""
        return self._run("reduce", MA.reduce_shared, v, [xs], [2 * self.m],
                         impl=impl)

    def modmul(self, a: list[int], b: list[int], v: int, *,
               impl: str | None = None) -> list[int]:
        """[(a_i * b_i) mod v] for a_i, b_i < B^m_limbs."""
        return self._run("modmul", MA.modmul_shared, v, [a, b],
                         [self.m, self.m], impl=impl)

    def modexp(self, a: list[int], e: list[int], v: int, *,
               impl: str | None = None) -> list[int]:
        """[pow(a_i, e_i, v)]: the fixed-window ladder on one cached
        shinv."""
        def fn(ctx, aa, ee, eff):
            return MA.modexp_shared(ctx, aa, ee,
                                    window_bits=self.window_bits, impl=eff)
        return self._run("modexp", fn, v, [a, e], [self.m, self.e_limbs],
                         impl=impl)

    def stats(self) -> dict:
        """Runtime counters and the context cache's; `bucket_compiles`
        counts the (op, bucket, impl) plans built, `bucket_reuses` the
        later uses."""
        out = self.telemetry.stats()
        out["bucket_compiles"] = self._plans.misses
        out["bucket_reuses"] = self._plans.hits
        with self._ctx_lock:
            total = self.ctx_hits + self.ctx_misses
            out["ctx_cache"] = {
                "hits": self.ctx_hits,
                "misses": self.ctx_misses,
                "evictions": self.ctx_evictions,
                "size": len(self._ctxs),
                "hit_rate": self.ctx_hits / total if total else 0.0,
            }
        return out

    def snapshot(self) -> dict:
        """Per-bucket KernelPlans beside the runtime counters."""
        return {
            "service": "modarith",
            "m_limbs": self.m,
            "e_limbs": self.e_limbs,
            "window_bits": self.window_bits,
            "impl": K.check_impl(self.impl),
            "buckets": {b: {"plan": p._asdict()}
                        for b, p in sorted(self.kernel_plans.items())},
            "runtime": self.stats(),
        }
