"""Modular-arithmetic service on cached Barrett contexts, on the card.

`ModArithService` keeps a bounded LRU cache of per-modulus
`BarrettContext`s on its device (one Newton-iterated shinv each) and
serves `reduce`, `modmul` and `modexp` over Python-int requests.  The
first request against a modulus pays the precompute; every later
request, and every step of a modexp ladder, reuses the cached shifted
inverse.  Requests are validated, split into bucket-sized chunks and
padded as in `BigintDivisionService`, with the same impl overrides,
compiled bucket executables, static profiles and fault-injection sites
(plus precompute).  The port of `repro/serving/modexp_service.py`
without a mesh.

Each (op, bucket, impl) runs one executable (`batching.CompiledBuckets`):
on the card a CUDA graph of the whole op, modexp's whole ladder
included, over static buffers for the context (v, mu, k) and the
request columns; a chunk copies the cached context and its columns in,
replays and copies the result out.  The precompute is an executable of
its own, keyed ("precompute", 1, impl) with a static v, in a cache of
its own (so `bucket_compiles` counts the request buckets, as in JAX);
its compile site is the precompute fault site, which fires before it.
`profile_bucket` builds an (op, bucket) executable without a request,
and `snapshot()` carries each bucket's static profile per op (and the
precompute's) for `obs/report.py:render_measured_vs_model`.
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
        self._fns = BT.CompiledBuckets()
        self._pre = BT.CompiledBuckets()            # the precompute's
        self.kernel_plans = self._fns.current       # bucket -> KernelPlan
        self.static_profiles: dict[int, dict] = {}  # bucket -> op -> profile
        self.precompute_profile: dict | None = None
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
            fn = self._precompute_fn()
            with T.annotate("modexp_service/precompute"):
                ctx = MA.BarrettContext(*fn(
                    bi.limbs_from_numpy(bi.from_int(v, self.m), "cpu")))
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

    # -- compiled per-bucket executables ----------------------------------

    def _precompute_fn(self) -> BT.Executable:
        """The precompute's executable over a static v (the service's
        impl), built on its first use."""
        impl = K.check_impl(self.impl)

        def build():
            v = torch.zeros(self.m, dtype=bi.DTYPE, device=self.device)
            v[0] = 1                              # the modulus 1
            exe = BT.Executable(partial(MA.barrett_precompute, impl=impl),
                                (v,), BT.kernel_plan(impl))
            self.precompute_profile = exe.static
            return exe
        return self._pre.use("precompute", 1, impl, impl, build)

    def _ctx_fill(self):
        """Shape-only context buffers (v = 1, mu = 0, k = 0)."""
        v = torch.zeros(self.m, dtype=bi.DTYPE, device=self.device)
        v[0] = 1
        mu = torch.zeros(MA.barrett_width(self.m), dtype=bi.DTYPE,
                         device=self.device)
        return v, mu, torch.zeros((), dtype=bi.DTYPE, device=self.device)

    def _op(self, op: str):
        """(fn(ctx, *columns, impl), column widths) of a request op."""
        if op == "reduce":
            return MA.reduce_shared, (2 * self.m,)
        if op == "modmul":
            return MA.modmul_shared, (self.m, self.m)
        if op == "modexp":
            return (partial(MA.modexp_shared, window_bits=self.window_bits),
                    (self.m, self.e_limbs))
        raise E.InvalidRequest(f"unknown op {op!r} for ModArithService")

    def _fn(self, op: str, bucket: int,
            impl: str | None = None) -> BT.Executable:
        """The (op, bucket, impl) executable over (v, mu, k, *columns),
        built on its first use (the compile fault site fires before the
        build)."""
        eff = K.check_impl(impl or self.impl)
        f, widths = self._op(op)

        def run(v, mu, k, *cols):
            return f(MA.BarrettContext(v, mu, k), *cols, impl=eff)

        def build():
            fill = self._ctx_fill() + tuple(
                torch.zeros(bucket, w, dtype=bi.DTYPE, device=self.device)
                for w in widths)
            exe = BT.Executable(run, fill, BT.kernel_plan(eff))
            self.static_profiles.setdefault(bucket, {})[op] = exe.static
            return exe
        return self._fns.use(op, bucket, eff, K.check_impl(self.impl),
                             build, partial(self._fire, "compile"))

    def profile_bucket(self, op: str, bucket: int) -> dict:
        """Build one (op, bucket) executable without a request and return
        the bucket's static profiles ({op: profile}); op "precompute"
        (bucket 1) builds the precompute's and returns {"precompute":
        profile}."""
        if op == "precompute":
            self._precompute_fn()
            return {"precompute": self.precompute_profile}
        self._op(op)
        self._fn(op, bucket)
        return self.static_profiles.get(bucket, {})

    # -- execution ------------------------------------------------------------

    def _run(self, op: str, v: int, columns, *,
             impl: str | None = None) -> list[int]:
        """Pack the int columns into limb batches per bucket, run the
        (op, bucket) executable on the modulus's context, unpack.
        `impl` overrides the service's impl for this call (the
        frontend's degradation ladder; every impl gives the same
        bits)."""
        n = self.validate(op, columns, v)
        if n == 0:
            return []
        eff = K.check_impl(impl or self.impl)
        _, widths = self._op(op)
        self.telemetry.record_request(op, n)
        ctx = self.context(v)
        out: list[int] = []
        for lo, hi, bucket in self.batcher.plan(n):
            self._fire("transfer", op=op, bucket=bucket)
            arrs = [bi.limbs_from_numpy(bi.batch_from_ints(
                        BT.pad_ints(col[lo:hi], bucket, 0), w), "cpu")
                    for col, w in zip(columns, widths)]
            fn = self._fn(op, bucket, eff)
            self.telemetry.record_rows(bucket, hi - lo)
            with T.annotate(f"modexp_service/{op}/b{bucket}"), \
                    self.telemetry.chunk_timer(op, bucket):
                self._fire("execute", op=op, bucket=bucket, impl=eff)
                res = bi.limbs_to_numpy(fn(*ctx, *arrs))
            out += bi.batch_to_ints(res[:hi - lo])
        return out

    def reduce(self, xs: list[int], v: int, *,
               impl: str | None = None) -> list[int]:
        """[x mod v] for double-width x (x < B^(2 m_limbs))."""
        return self._run("reduce", v, [xs], impl=impl)

    def modmul(self, a: list[int], b: list[int], v: int, *,
               impl: str | None = None) -> list[int]:
        """[(a_i * b_i) mod v] for a_i, b_i < B^m_limbs."""
        return self._run("modmul", v, [a, b], impl=impl)

    def modexp(self, a: list[int], e: list[int], v: int, *,
               impl: str | None = None) -> list[int]:
        """[pow(a_i, e_i, v)]: the fixed-window ladder on one cached
        shinv."""
        return self._run("modexp", v, [a, e], impl=impl)

    def stats(self) -> dict:
        """Runtime counters and the context cache's; `bucket_compiles`
        counts the (op, bucket, impl) executables built, `bucket_reuses`
        the later uses (the precompute's executables apart)."""
        out = self.telemetry.stats()
        out["bucket_compiles"] = self._fns.misses
        out["bucket_reuses"] = self._fns.hits
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
        """Merged static and runtime profile: per bucket the KernelPlan
        and the static launch profile of each op, the precompute's
        (once built) and the runtime counters.  Render with
        `obs/report.py:render_measured_vs_model`."""
        out = {
            "service": "modarith",
            "m_limbs": self.m,
            "e_limbs": self.e_limbs,
            "window_bits": self.window_bits,
            "impl": K.check_impl(self.impl),
            "device": self.device.type,
            "buckets": BT.snapshot_buckets(self.kernel_plans,
                                           self.static_profiles),
            "runtime": self.stats(),
        }
        pre = self._pre.current.get(1)
        if pre is not None:
            out["precompute"] = {"plan": pre._asdict(),
                                 "static": self.precompute_profile}
        return out
