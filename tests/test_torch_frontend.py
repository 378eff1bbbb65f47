"""The port's serving tier on the CPU: exception taxonomy, deterministic
fault injection, retry and backoff, deadlines, circuit breakers, the
impl ladder and the async frontend's accounting (every admitted request
gets a terminal answer); the scenarios of tests/test_serving_faults.py.

Where the JAX services can run (`capture_profiles=False`), the same
seeded plan also goes through the JAX package's `AsyncFrontend`, and
the results, the `healthz()` counts and the quarantine set must agree,
with the impl names mapped by `ops.JAX_IMPLS`.  Time comes from fake
clocks; the only real sleeps are millisecond retry backoffs.
"""

import asyncio
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest
import torch

from repro.serving import errors as JE
from repro.serving import faults as JF
from repro.serving import frontend as JFE
from repro.serving import policy as JP
from repro.serving.bigint_service import \
    BigintDivisionService as JBigintService
from repro.serving.modexp_service import ModArithService as JModService
from repro_torch.core import bigint as bi
from repro_torch.core import shinv as S
from repro_torch.kernels import build
from repro_torch.kernels import ops as K
from repro_torch.serving import batching as BT
from repro_torch.serving import errors as E
from repro_torch.serving.bigint_service import BigintDivisionService
from repro_torch.serving.faults import FaultInjector, FaultSpec
from repro_torch.serving.frontend import AsyncFrontend
from repro_torch.serving.modexp_service import ModArithService
from repro_torch.serving.policy import (CircuitBreaker, KernelLadder,
                                        ServingPolicy, backoff_delay)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its limb tensors are
    a few dozen elements wide, and the test workers share the host's
    cores (at torch's default of one thread per core they oversubscribe
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = bi.BASE
FAST = dict(max_retries=3, backoff_base=0.001, backoff_cap=0.004,
            breaker_cooldown=10.0)

# the two stacks, with the impl names each one uses
PORT = SimpleNamespace(
    E=E, Frontend=AsyncFrontend, Policy=ServingPolicy,
    Injector=FaultInjector, Spec=FaultSpec, name=lambda i: i,
    modarith=lambda m, impl, **kw: ModArithService(
        m_limbs=m, e_limbs=1, impl=impl, device="cpu", **kw),
    bigint=lambda m, impl, **kw: BigintDivisionService(
        m_limbs=m, impl=impl, device="cpu", **kw))
JAX = SimpleNamespace(
    E=JE, Frontend=JFE.AsyncFrontend, Policy=JP.ServingPolicy,
    Injector=JF.FaultInjector, Spec=JF.FaultSpec,
    name=lambda i: K.JAX_IMPLS[i],
    modarith=lambda m, impl, **kw: JModService(
        m_limbs=m, e_limbs=1, impl=K.JAX_IMPLS[impl],
        capture_profiles=False, **kw),
    bigint=lambda m, impl, **kw: JBigintService(
        m_limbs=m, impl=K.JAX_IMPLS[impl], capture_profiles=False, **kw))


def run(coro):
    return asyncio.run(coro)


def _modarith(m=3, impl="blocked", **kw):
    kw.setdefault("batch_buckets", (4,))
    return PORT.modarith(m, impl, **kw)


def _mapped(health, stack):
    """healthz() with every impl name in the port's spelling."""
    back = {stack.name(i): i for i in K.IMPLS}

    def key(k):
        impl, rest = k.split("/", 1)
        return f"{back[impl]}/{rest}"
    h = dict(health)
    h["quarantine"] = [key(k) for k in health["quarantine"]]
    h["breakers"] = {key(k): s for k, s in health["breakers"].items()}
    return h


# ---------------------------------------------------------------------------
# taxonomy / classification
# ---------------------------------------------------------------------------

def test_classify_taxonomy():
    cases = [
        (E.Overloaded(reason="queue_depth"), "overload"),
        (E.DeadlineExceeded(op="divmod"), "deadline"),
        (E.InvalidRequest("bad"), "invalid"),
        (E.OperandRangeError("x[3] out of range"), "invalid"),
        (E.OperandTypeError("x[0]: expected int"), "invalid"),
        (ValueError("whatever"), "invalid"),
        (E.CompileFault(impl="cuda_fused"), "kernel"),
        (E.ExecuteFault(transient=True), "transient"),
        (E.ExecuteFault(transient=False), "kernel"),
        (E.TransferFault(), "transient"),
        (E.PrecomputeFault(), "transient"),
        (E.ServingError("boom"), "fatal"),
        (RuntimeError("segfault adjacent"), "fatal"),
    ]
    for exc, kind in cases:
        assert E.classify(exc) == kind, (exc, kind)
    assert isinstance(E.OperandRangeError(""), OverflowError)
    assert isinstance(E.OperandTypeError(""), TypeError)
    assert isinstance(E.InvalidRequest(""), ValueError)
    assert isinstance(E.DeadlineExceeded(""), TimeoutError)


def test_classify_card_errors():
    """The card's real faults are fatal: a refused or failed launch,
    CUDA out of memory and a kernel that does not build all reach the
    caller (the frontend never degrades around a kernel that fails)."""
    assert E.classify(build.LaunchError("mul_pairs kernel", 9)) == "fatal"
    assert E.classify(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == "fatal"
    assert E.classify(RuntimeError("CUDA out of memory")) == "fatal"
    assert E.classify(build.BuildError("nvcc failed for pairs.cu")) == \
        "fatal"
    assert E.classify(build.BuildError("nvcc failed: out of memory")) == \
        "fatal"
    with pytest.raises(build.LaunchError) as ei:
        build.check(2, "x kernel")
    assert ei.value.code == 2


# ---------------------------------------------------------------------------
# fault injector determinism
# ---------------------------------------------------------------------------

def test_injector_skip_times_window_and_heal():
    inj = FaultInjector([FaultSpec(site="execute", op="modmul",
                                   skip=1, times=2)])
    inj.fire("execute", op="modmul")            # skipped
    with pytest.raises(E.ExecuteFault):
        inj.fire("execute", op="modmul")        # 1st armed
    with pytest.raises(E.ExecuteFault):
        inj.fire("execute", op="modmul")        # 2nd armed
    inj.fire("execute", op="modmul")            # healed
    inj.fire("execute", op="reduce")            # label mismatch: never
    st = inj.stats()
    assert st["fired_total"] == 2
    assert st["by_site"]["execute"] == 2
    assert st["specs"][0]["seen"] == 4


def _firing_pattern(stack, seed):
    inj = stack.Injector([stack.Spec(site="execute", rate=0.5, times=0)],
                         seed=seed)
    out = []
    for _ in range(32):
        try:
            inj.fire("execute", op="x")
            out.append(0)
        except stack.E.ExecuteFault:
            out.append(1)
    return out


def test_injector_rate_is_seeded_deterministic_like_jax():
    a = _firing_pattern(PORT, 7)
    assert a == _firing_pattern(PORT, 7) and 0 < sum(a) < 32
    assert _firing_pattern(PORT, 8) != a
    # one seed draws the same faults in both packages
    assert a == _firing_pattern(JAX, 7)


def test_injector_reset_and_kinds():
    inj = FaultInjector([FaultSpec(site="compile", kind="compile"),
                         FaultSpec(site="transfer")])
    with pytest.raises(E.CompileFault):
        inj.fire("compile", op="divmod", impl="cuda_fused")
    with pytest.raises(E.TransferFault):
        inj.fire("transfer", op="divmod")
    inj.fire("compile", op="divmod", impl="cuda_fused")   # exhausted
    inj.reset()
    with pytest.raises(E.CompileFault):
        inj.fire("compile", op="divmod", impl="cuda_fused")
    with pytest.raises(ValueError):
        FaultInjector([FaultSpec(site="nope")])
    with pytest.raises(ValueError):
        FaultInjector([FaultSpec(site="execute", kind="nope")])


# ---------------------------------------------------------------------------
# policy: backoff, breaker, ladder
# ---------------------------------------------------------------------------

def test_backoff_grows_and_caps_deterministically():
    pol = ServingPolicy(backoff_base=0.01, backoff_cap=0.05,
                        backoff_jitter=0.0)
    delays = [backoff_delay(pol, a) for a in range(1, 6)]
    assert delays == [0.01, 0.02, 0.04, 0.05, 0.05]
    rng1, rng2 = random.Random(3), random.Random(3)
    pol = ServingPolicy(backoff_base=0.01, backoff_jitter=0.5)
    jpol = JP.ServingPolicy(backoff_base=0.01, backoff_jitter=0.5)
    assert [backoff_delay(pol, 1, rng1) for _ in range(4)] == \
           [JP.backoff_delay(jpol, 1, rng2) for _ in range(4)]


def test_breaker_open_half_open_close_transitions():
    clock = [0.0]
    br = CircuitBreaker(threshold=2, cooldown=10.0,
                        clock=lambda: clock[0])
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "open" and not br.allow()
    clock[0] = 9.9
    assert br.state == "open" and not br.allow()
    clock[0] = 10.0
    assert br.state == "half_open"
    assert br.allow()
    assert not br.allow()
    br.record_success()
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_failure()
    clock[0] = 20.0
    assert br.allow()
    br.record_failure()
    assert br.state == "open" and not br.allow()
    clock[0] = 30.0
    assert br.allow() and not br.allow()
    br.release_probe()
    assert br.allow()


@pytest.mark.parametrize("requested", ["cuda_fused", "cuda_pairs"])
def test_kernel_ladder_walks_fallback_chain(requested):
    clock = [0.0]
    lad = KernelLadder(ServingPolicy(breaker_cooldown=5.0),
                       clock=lambda: clock[0])
    chain = K.fallback_chain(requested)
    for i, impl in enumerate(chain):
        assert lad.select(requested, 4, 8) == impl
        lad.record_failure(impl, 4, 8)
    assert lad.select(requested, 4, 8) is None          # exhausted
    assert lad.quarantined() == sorted(f"{i}/b4/m8" for i in chain)
    assert lad.select(requested, 8, 8) == requested     # other bucket
    clock[0] = 5.0                                      # probes come back
    assert lad.select(requested, 4, 8) == requested
    lad.record_success(requested, 4, 8)
    assert f"{requested}/b4/m8" not in lad.quarantined()


@pytest.mark.parametrize("requested", ["cuda_fused", "cuda_pairs",
                                       "blocked"])
def test_kernel_ladder_on_the_card_stops_at_a_kernel(requested):
    """A ladder for a service on the card never falls to blocked: its
    chain ends at the last kernel rung, unless blocked was asked for."""
    lad = KernelLadder(ServingPolicy(), clock=lambda: 0.0, device="cuda")
    chain = {"cuda_fused": ["cuda_fused", "cuda_batched"],
             "cuda_pairs": ["cuda_pairs"], "blocked": ["blocked"]}[requested]
    for impl in chain:
        assert lad.select(requested, 4, 8) == impl
        lad.record_failure(impl, 4, 8)
    assert lad.select(requested, 4, 8) is None
    assert lad.quarantined() == sorted(f"{i}/b4/m8" for i in chain)


# ---------------------------------------------------------------------------
# thread safety: caches under concurrent requests
# ---------------------------------------------------------------------------

def test_concurrent_requests_single_plan_and_precompute():
    rnd = random.Random(11)
    m = 3
    svc = _modarith(m, "cuda_pairs")
    v = rnd.randint(2, B ** m - 1)
    cols = [([rnd.randint(0, B ** m - 1) for _ in range(4)],
             [rnd.randint(0, B ** m - 1) for _ in range(4)])
            for _ in range(16)]
    start = threading.Barrier(8)

    def worker(i):
        start.wait()
        a, b = cols[i % len(cols)]
        return svc.modmul(a, b, v)

    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(worker, range(16)))
    for i, res in enumerate(results):
        a, b = cols[i % len(cols)]
        assert res == [(x * y) % v for x, y in zip(a, b)]
    assert svc.ctx_misses == 1 and len(svc._ctxs) == 1
    assert svc._fns.misses == 1 and svc._fns.hits == 15
    st = svc.stats()
    assert (st["bucket_compiles"], st["bucket_reuses"]) == (1, 15)
    assert st["requests"] == {"modmul": 16} and st["rows_true"] == 64


def test_concurrent_context_lru_stays_consistent():
    rnd = random.Random(12)
    m = 2
    svc = _modarith(m, batch_buckets=(2,), max_cached_moduli=3)
    vs = [rnd.randint(2, B ** m - 1) for _ in range(9)]
    with ThreadPoolExecutor(max_workers=6) as pool:
        list(pool.map(svc.context, vs * 4))
    assert len(svc._ctxs) == 3
    assert svc.ctx_misses + svc.ctx_hits == 36
    assert svc.ctx_evictions == svc.ctx_misses - 3
    ev = svc.telemetry.registry.get("ctx_cache_total")
    assert ev.labels(event="eviction").value == svc.ctx_evictions


# ---------------------------------------------------------------------------
# async frontend: retry, deadlines, overload (held to the JAX frontend)
# ---------------------------------------------------------------------------

def _retry_plan(stack):
    """modmul with two transient execute faults: retried, exact."""
    rnd = random.Random(21)
    svc = stack.modarith(3, "blocked", batch_buckets=(4,))
    v = rnd.randint(2, B ** 3 - 1)
    a = [rnd.randint(0, B ** 3 - 1) for _ in range(6)]
    b = [rnd.randint(0, B ** 3 - 1) for _ in range(6)]
    inj = stack.Injector([stack.Spec(site="execute", op="modmul",
                                     times=2)])

    async def main():
        async with stack.Frontend(svc, policy=stack.Policy(**FAST),
                                  faults=inj) as fe:
            res = await fe.submit("modmul", a, b, v=v)
            return res, fe.healthz(), fe.snapshot()["faults"]
    res, health, faults = run(main())
    assert res == [(x * y) % v for x, y in zip(a, b)]
    return res, _mapped(health, stack), faults


def test_frontend_retries_transient_faults_like_jax():
    res, health, faults = _retry_plan(PORT)
    assert health["retries"] == 2 and health["dropped"] == 0
    assert faults["fired_total"] == 2
    jres, jhealth, jfaults = _retry_plan(JAX)
    assert (res, health, faults) == (jres, jhealth, jfaults)


def test_frontend_transient_exhaustion_raises_terminal_error():
    rnd = random.Random(22)
    svc = _modarith()
    v = rnd.randint(2, B ** 3 - 1)
    inj = FaultInjector([FaultSpec(site="execute", times=0)])
    pol = ServingPolicy(max_retries=2, backoff_base=0.001,
                        backoff_cap=0.002)

    async def main():
        async with AsyncFrontend(svc, policy=pol, faults=inj) as fe:
            with pytest.raises(E.ExecuteFault):
                await fe.submit("reduce", [5], v=v)
            h = fe.healthz()
            assert h["retries"] == 2 and h["dropped"] == 0
            failed = fe.metrics.failed.labels(op="reduce", kind="transient")
            assert failed.value == 1
    run(main())


def test_frontend_precompute_fault_is_retried():
    rnd = random.Random(23)
    svc = _modarith()
    v = rnd.randint(2, B ** 3 - 1)
    inj = FaultInjector([FaultSpec(site="precompute", times=1)])

    async def main():
        async with AsyncFrontend(svc, policy=ServingPolicy(**FAST),
                                 faults=inj) as fe:
            assert await fe.submit("reduce", [B ** 3 + 5], v=v) == \
                [(B ** 3 + 5) % v]
            assert fe.healthz()["retries"] == 1
    run(main())
    assert svc.ctx_misses == 1                  # the fault fired pre-miss


class _TickingClock(FaultInjector):
    """Advances a fake clock by 1.0 at every execute site: one tick per
    chunk execution, no real time."""

    def __init__(self, box):
        super().__init__([])
        self.box = box

    def fire(self, site, **labels):
        if site == "execute":
            self.box[0] += 1.0


def test_frontend_deadline_expires_between_chunks():
    rnd = random.Random(24)
    svc = _modarith()
    v = rnd.randint(2, B ** 3 - 1)
    xs = [rnd.randint(0, B ** 6 - 1) for _ in range(8)]
    clock = [0.0]

    async def main():
        async with AsyncFrontend(svc, policy=ServingPolicy(**FAST),
                                 faults=_TickingClock(clock),
                                 clock=lambda: clock[0]) as fe:
            with pytest.raises(E.DeadlineExceeded) as ei:
                await fe.submit("reduce", xs, v=v, timeout=0.5)
            assert ei.value.completed == 4 and ei.value.total == 8
            h = fe.healthz()
            assert h["deadline_exceeded"] == 1 and h["dropped"] == 0
            assert sum(s.value for s in
                       fe.metrics.chunks_cancelled.series()) == 1
            clock[0] = 0.0
            assert await fe.submit("reduce", xs[:2], v=v) == \
                [x % v for x in xs[:2]]
    run(main())
    assert svc.telemetry.stats()["rows_true"] == 4 + 2


def test_frontend_already_expired_deadline_never_executes():
    rnd = random.Random(25)
    svc = _modarith()
    v = rnd.randint(2, B ** 3 - 1)

    async def main():
        async with AsyncFrontend(svc, policy=ServingPolicy(**FAST)) as fe:
            with pytest.raises(E.DeadlineExceeded) as ei:
                await fe.submit("reduce", [1, 2, 3], v=v, timeout=0.0)
            assert ei.value.completed == 0 and ei.value.total == 3
    run(main())
    assert svc.telemetry.stats()["rows_true"] == 0


def test_frontend_overload_sheds_typed_rejections():
    rnd = random.Random(26)
    svc = _modarith()
    v = rnd.randint(2, B ** 3 - 1)
    pol = ServingPolicy(max_queue_depth=1, **FAST)

    async def main():
        async with AsyncFrontend(svc, policy=pol) as fe:
            r1, r2 = await asyncio.gather(
                fe.submit("reduce", [7], v=v),
                fe.submit("reduce", [8], v=v), return_exceptions=True)
            assert r1 == [7 % v]
            assert isinstance(r2, E.Overloaded)
            assert r2.reason == "queue_depth"
            assert fe.metrics.rejected.labels(
                reason="queue_depth").value == 1
            assert fe.healthz()["dropped"] == 0
    run(main())


def test_frontend_queued_work_estimate_limit():
    rnd = random.Random(27)
    svc = _modarith()
    v = rnd.randint(2, B ** 3 - 1)
    pol = ServingPolicy(max_queued_items=4, **FAST)

    async def main():
        async with AsyncFrontend(svc, policy=pol) as fe:
            big = [rnd.randint(0, B ** 3 - 1) for _ in range(3)]
            r1, r2 = await asyncio.gather(
                fe.submit("reduce", big, v=v),
                fe.submit("reduce", big, v=v), return_exceptions=True)
            assert r1 == [x % v for x in big]
            assert isinstance(r2, E.Overloaded)
            assert r2.reason == "queued_work"
    run(main())


def test_frontend_coalesces_concurrent_requests_into_one_bucket():
    rnd = random.Random(28)
    svc = _modarith()
    v = rnd.randint(2, B ** 3 - 1)
    a = [rnd.randint(0, B ** 3 - 1) for _ in range(4)]
    b = [rnd.randint(0, B ** 3 - 1) for _ in range(4)]

    async def main():
        async with AsyncFrontend(svc, policy=ServingPolicy(**FAST)) as fe:
            outs = await asyncio.gather(*[
                fe.submit("modmul", [a[i]], [b[i]], v=v) for i in range(4)])
            assert [o[0] for o in outs] == \
                [(x * y) % v for x, y in zip(a, b)]
    run(main())
    assert svc.telemetry.stats()["rows_padded"] <= 8


def test_frontend_stop_without_drain_cancels_queued():
    rnd = random.Random(29)
    svc = _modarith()
    v = rnd.randint(2, B ** 3 - 1)

    async def main():
        fe = AsyncFrontend(svc, policy=ServingPolicy(**FAST))
        await fe.start()
        await fe.stop(drain=False)
        with pytest.raises(E.Overloaded):
            await fe.submit("reduce", [1], v=v)
        assert fe.healthz()["status"] == "stopped"
        assert not fe.ready()
    run(main())


# ---------------------------------------------------------------------------
# the impl ladder
# ---------------------------------------------------------------------------

def _degrade_plan(stack):
    """A compile fault on every cuda_fused plan: quarantined, degraded
    to cuda_batched, exact."""
    rnd = random.Random(31)
    m = 4
    svc = stack.bigint(m, "cuda_fused", batch_buckets=(4,))
    us = [rnd.randint(0, B ** m - 1) for _ in range(6)]
    vs = [rnd.randint(1, B ** m - 1) for _ in range(6)]
    inj = stack.Injector([stack.Spec(site="compile",
                                     impl=stack.name("cuda_fused"),
                                     kind="compile", times=0)])

    async def main():
        async with stack.Frontend(svc, policy=stack.Policy(**FAST),
                                  faults=inj) as fe:
            res = await fe.submit("divmod", us, vs)
            deg = fe.metrics.degraded.labels(
                from_impl=stack.name("cuda_fused"),
                to_impl=stack.name("cuda_batched")).value
            return res, fe.healthz(), deg
    (qs, rs), health, deg = run(main())
    assert qs == [u // v for u, v in zip(us, vs)]
    assert rs == [u % v for u, v in zip(us, vs)]
    plan = svc.kernel_plans[4]
    return ((qs, rs), _mapped(health, stack), deg,
            (plan.impl, plan.degraded_from))


def test_frontend_degrades_on_compile_fault_like_jax():
    res, health, deg, plan = _degrade_plan(PORT)
    assert health["status"] == "degraded"
    assert health["quarantine"] == ["cuda_fused/b4/m4"]
    assert health["dropped"] == 0 and deg >= 1
    assert plan == ("cuda_batched", "cuda_fused")
    jres, jhealth, jdeg, jplan = _degrade_plan(JAX)
    assert (res, health, deg) == (jres, jhealth, jdeg)
    assert jplan == tuple(JAX.name(i) for i in plan)


def test_frontend_pairs_compile_fault_degrades_to_blocked():
    rnd = random.Random(35)
    m = 3
    svc = _modarith(m, "cuda_pairs")
    v = rnd.randint(2, B ** m - 1)
    a = [rnd.randint(0, B ** m - 1) for _ in range(5)]
    e = [rnd.randint(0, B - 1) for _ in range(5)]
    inj = FaultInjector([FaultSpec(site="compile", impl="cuda_pairs",
                                   kind="compile", times=0)])

    async def main():
        async with AsyncFrontend(svc, policy=ServingPolicy(**FAST),
                                 faults=inj) as fe:
            got = await fe.submit("modexp", a, e, v=v)
            assert got == [pow(x, y, v) for x, y in zip(a, e)]
            h = fe.healthz()
            assert h["quarantine"] == ["cuda_pairs/b4/m3"]
            assert h["dropped"] == 0 and h["status"] == "degraded"
            assert fe.metrics.degraded.labels(
                from_impl="cuda_pairs", to_impl="blocked").value == 2
    run(main())
    assert svc.kernel_plans[4] == BT.kernel_plan("blocked")._replace(
        degraded_from="cuda_pairs")
    snap = svc.snapshot()
    assert snap["buckets"][4]["plan"]["degraded_from"] == "cuda_pairs"
    assert snap["impl"] == "cuda_pairs"


def test_frontend_on_the_card_pairs_compile_fault_reaches_the_caller():
    """The frontend's ladder follows its service's device; with the
    card's ladder a compile fault on cuda_pairs has no rung below it, so
    the request fails with the fault and nothing runs on blocked."""
    rnd = random.Random(37)
    m = 3
    svc = _modarith(m, "cuda_pairs")
    v = rnd.randint(2, B ** m - 1)
    inj = FaultInjector([FaultSpec(site="compile", impl="cuda_pairs",
                                   kind="compile", times=0)])

    async def main():
        async with AsyncFrontend(svc, policy=ServingPolicy(**FAST),
                                 faults=inj) as fe:
            assert fe.ladder.device == svc.device
            fe.ladder = KernelLadder(fe.policy, clock=fe.clock,
                                     device="cuda")
            with pytest.raises(E.CompileFault):
                await fe.submit("reduce", [5, 9], v=v)
            h = fe.healthz()
            assert h["quarantine"] == ["cuda_pairs/b4/m3"]
            assert h["dropped"] == 0
            assert not list(fe.metrics.degraded.series())
    run(main())
    assert svc.kernel_plans == {}


def test_frontend_half_open_probe_restores_healed_kernel():
    rnd = random.Random(32)
    m = 2
    svc = PORT.bigint(m, "cuda_fused", batch_buckets=(2,))
    inj = FaultInjector([FaultSpec(site="compile", impl="cuda_fused",
                                   kind="compile", times=1)])
    clock = [0.0]
    pol = ServingPolicy(**FAST)

    async def main():
        async with AsyncFrontend(svc, policy=pol, faults=inj,
                                 clock=lambda: clock[0]) as fe:
            us = [rnd.randint(0, B ** m - 1) for _ in range(2)]
            vs = [rnd.randint(1, B ** m - 1) for _ in range(2)]
            await fe.submit("divmod", us, vs)
            assert fe.healthz()["quarantine"] == ["cuda_fused/b2/m2"]
            assert svc.kernel_plans[2].degraded_from == "cuda_fused"
            clock[0] = pol.breaker_cooldown + 1.0
            qs, rs = await fe.submit("divmod", us, vs)
            assert qs == [u // v for u, v in zip(us, vs)]
            assert fe.healthz()["quarantine"] == []
            assert fe.healthz()["status"] == "ok"
            assert svc.kernel_plans[2].impl == "cuda_fused"
            assert svc.kernel_plans[2].degraded_from == ""
    run(main())


def _exhaust_plan(stack):
    rnd = random.Random(33)
    svc = stack.modarith(3, "blocked", batch_buckets=(4,))
    v = rnd.randint(2, B ** 3 - 1)
    inj = stack.Injector([stack.Spec(site="execute", kind="kernel",
                                     times=0)])

    async def main():
        async with stack.Frontend(svc, policy=stack.Policy(**FAST),
                                  faults=inj) as fe:
            with pytest.raises(stack.E.ExecuteFault):
                await fe.submit("reduce", [9], v=v)
            return fe.healthz()
    return _mapped(run(main()), stack)


def test_frontend_ladder_exhaustion_is_a_typed_terminal_error_like_jax():
    h = _exhaust_plan(PORT)
    assert h["dropped"] == 0 and "blocked/b4/m3" in h["quarantine"]
    assert h == _exhaust_plan(JAX)


def test_frontend_launch_and_build_errors_are_fatal(monkeypatch):
    """A refused launch or a kernel that does not build fails the
    request without touching the ladder: no quarantine, no fallback."""
    rnd = random.Random(36)
    m = 4
    svc = PORT.bigint(m, "cuda_fused", batch_buckets=(4,))
    us = [rnd.randint(0, B ** m - 1) for _ in range(3)]
    vs = [rnd.randint(1, B ** m - 1) for _ in range(3)]
    orig = S.divmod_batch
    raised = {}

    def divmod_batch(u, v, windowed=True, impl=None):
        if impl in raised:
            raise raised[impl]
        return orig(u, v, windowed=windowed, impl=impl)
    monkeypatch.setattr(S, "divmod_batch", divmod_batch)

    async def main():
        async with AsyncFrontend(svc, policy=ServingPolicy(**FAST)) as fe:
            qs, _ = await fe.submit("divmod", us, vs)
            assert qs == [u // v for u, v in zip(us, vs)]
            raised["cuda_fused"] = build.LaunchError("powdiff kernel", 7)
            with pytest.raises(build.LaunchError):
                await fe.submit("divmod", us, vs)
            raised["cuda_fused"] = build.BuildError("nvcc failed")
            with pytest.raises(build.BuildError):
                await fe.submit("divmod", us, vs)
            h = fe.healthz()
            assert h["quarantine"] == [] and h["dropped"] == 0
            assert fe.metrics.faults.labels(op="divmod",
                                            kind="fatal").value == 2
            assert not list(fe.metrics.degraded.series())
    run(main())
    assert svc.kernel_plans[4].degraded_from == ""


# ---------------------------------------------------------------------------
# metrics, validation
# ---------------------------------------------------------------------------

def test_frontend_metrics_export_is_merged_and_parseable():
    rnd = random.Random(34)
    svc = _modarith()
    v = rnd.randint(2, B ** 3 - 1)

    async def main():
        async with AsyncFrontend(svc, policy=ServingPolicy(**FAST)) as fe:
            await fe.submit("reduce", [1, 2], v=v)
            lines = fe.metrics_lines()
            names = {ln.split("{")[0].split(" ")[0] for ln in lines}
            assert "queue_depth" in names
            assert "admitted_total" in names
            assert any(n.startswith("request_seconds") for n in names)
            assert any(n.startswith("requests_total") for n in names)
            assert "ctx_cache_total" in names
            for ln in lines:
                float(ln.rsplit(" ", 1)[1])
            snap = fe.snapshot()
            assert snap["service"]["runtime"]["requests"] == {"reduce": 1}
            assert "faults" not in snap
    run(main())


def test_frontend_validation_rejects_before_admission():
    svc = _modarith()

    async def main():
        async with AsyncFrontend(svc, policy=ServingPolicy(**FAST)) as fe:
            with pytest.raises(E.InvalidRequest):
                await fe.submit("nope", [1], v=5)
            with pytest.raises(E.OperandTypeError):
                await fe.submit("reduce", [1.5], v=5)
            with pytest.raises(E.InvalidRequest):
                await fe.submit("modmul", [1], [2, 3], v=5)
            with pytest.raises(E.InvalidRequest):
                await fe.submit("reduce", [1])
            assert await fe.submit("reduce", [], v=5) == []
            assert fe.metrics.rejected.labels(reason="invalid").value == 4
            assert fe.healthz()["queue_depth"] == 0
    run(main())


def test_services_refuse_unknown_impl():
    with pytest.raises(ValueError):
        _modarith(impl="pallas")
    with pytest.raises(ValueError):
        PORT.bigint(2, "scan")


def test_profiling_names_service_spans():
    """With profiling on, each service chunk is a named range in a
    torch.profiler trace; off, nothing is recorded."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import telemetry as T
    svc = PORT.bigint(2, "cuda_fused", batch_buckets=(2,))
    for on in (True, False):
        T.set_profiling(on)
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                assert svc.divide([7, 9], [2, 0]) == ([3, 0], [1, 9])
        finally:
            T.set_profiling(False)
        names = {e.name for e in prof.events()}
        assert ("bigint_service/divmod/b2" in names) == on
