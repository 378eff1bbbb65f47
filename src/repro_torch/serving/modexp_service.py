"""Modular-arithmetic service on cached Barrett contexts, on the card.

`ModArithService` keeps a bounded LRU cache of per-modulus
`BarrettContext`s on its device (one Newton-iterated shinv each) and
serves `reduce`, `modmul` and `modexp` over Python-int requests.  The
first request against a modulus pays the precompute; every later
request, and every step of a modexp ladder, reuses the cached shifted
inverse.  Requests are validated, split into bucket-sized chunks and
padded as in `BigintDivisionService`.  The port of
`repro/serving/modexp_service.py` without fault injection, impl
overrides, trace profiles or a mesh.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from repro_torch.core import bigint as bi
from repro_torch.core import modarith as MA
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
    """

    def __init__(self, m_limbs: int, e_limbs: int | None = None,
                 window_bits: int = 4, batch_buckets=(64, 256, 1024),
                 max_cached_moduli: int = 64, device="cuda"):
        self.m = m_limbs
        self.e_limbs = e_limbs if e_limbs is not None else m_limbs
        self.window_bits = window_bits
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ModArithService(device='cuda') needs a "
                               "CUDA device; pass device='cpu' to run the "
                               "plain versions on the CPU")
        self.batcher = BT.Batcher(batch_buckets)
        self.telemetry = BT.ServiceMetrics()
        self._ctxs: OrderedDict[int, MA.BarrettContext] = OrderedDict()
        self._ctx_lock = threading.RLock()
        self.max_cached = max_cached_moduli
        self.ctx_hits = 0
        self.ctx_misses = 0
        self.ctx_evictions = 0

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
                return self._ctxs[v]
            self.ctx_misses += 1
            ctx = MA.barrett_precompute(
                bi.limbs_from_numpy(bi.from_int(v, self.m), self.device))
            self._ctxs[v] = ctx
            while len(self._ctxs) > self.max_cached:
                self._ctxs.popitem(last=False)
                self.ctx_evictions += 1
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

    def _run(self, op: str, fn, v: int, columns, widths) -> list[int]:
        """Pack the int columns into limb batches per bucket, run fn with
        the modulus's context, unpack."""
        n = self.validate(op, columns, v)
        if n == 0:
            return []
        self.telemetry.record_request(op, n)
        ctx = self.context(v)
        out: list[int] = []
        for lo, hi, bucket in self.batcher.plan(n):
            arrs = [bi.limbs_from_numpy(bi.batch_from_ints(
                        BT.pad_ints(col[lo:hi], bucket, 0), w), self.device)
                    for col, w in zip(columns, widths)]
            self.telemetry.record_rows(bucket, hi - lo)
            with self.telemetry.chunk_timer(op, bucket):
                res = bi.limbs_to_numpy(fn(ctx, *arrs))
            out += bi.batch_to_ints(res[:hi - lo])
        return out

    def reduce(self, xs: list[int], v: int) -> list[int]:
        """[x mod v] for double-width x (x < B^(2 m_limbs))."""
        return self._run("reduce", MA.reduce_shared, v, [xs], [2 * self.m])

    def modmul(self, a: list[int], b: list[int], v: int) -> list[int]:
        """[(a_i * b_i) mod v] for a_i, b_i < B^m_limbs."""
        return self._run("modmul", MA.modmul_shared, v, [a, b],
                         [self.m, self.m])

    def modexp(self, a: list[int], e: list[int], v: int) -> list[int]:
        """[pow(a_i, e_i, v)]: the fixed-window ladder on one cached
        shinv."""
        def fn(ctx, aa, ee):
            return MA.modexp_shared(ctx, aa, ee,
                                    window_bits=self.window_bits)
        return self._run("modexp", fn, v, [a, e], [self.m, self.e_limbs])

    def stats(self) -> dict:
        """Runtime counters and the context cache's."""
        out = self.telemetry.stats()
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
