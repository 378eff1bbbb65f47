"""Fault-tolerant async serving frontend on the port: demo + chaos
smoke.

Default mode drives the `AsyncFrontend` over a `ModArithService` with
concurrent mixed traffic (reduce / modmul / modexp requests coalescing
into shared buckets) and prints the health surface and merged metric
export.

`--chaos-smoke` injects a seeded compile fault plus transient execute
faults while traffic runs, and asserts the robustness contract:

  * results stay BIT-IDENTICAL to the no-fault path (degradation falls
    down the registry ladder of bit-equivalent impls),
  * the snapshot records the quarantined impl and the retry counts,
  * the queue-depth gauge is exported,
  * zero requests are dropped (every admitted request gets a terminal
    answer), and
  * a deadline-expired request raises typed `DeadlineExceeded`.

Run:  python -m repro_torch.examples.serving_frontend [--device cpu]
      python -m repro_torch.examples.serving_frontend --chaos-smoke
(with PYTHONPATH=src from the repository root)
"""

import asyncio
import random

from repro_torch.core import bigint as bi
from repro_torch.examples.common import parse_device
from repro_torch.obs import report
from repro_torch.obs.telemetry import merged_collect
from repro_torch.serving import errors as E
from repro_torch.serving.bigint_service import BigintDivisionService
from repro_torch.serving.faults import FaultInjector, FaultSpec
from repro_torch.serving.frontend import AsyncFrontend
from repro_torch.serving.modexp_service import ModArithService
from repro_torch.serving.policy import ServingPolicy

B = bi.BASE


async def demo(dev) -> None:
    m = 8
    rnd = random.Random(42)
    svc = ModArithService(m_limbs=m, e_limbs=2, batch_buckets=(16,),
                          device=dev)
    v = rnd.randint(2, B ** m - 1)
    pol = ServingPolicy(max_queue_depth=64)
    async with AsyncFrontend(svc, policy=pol) as fe:
        xs = [rnd.randint(0, B ** (2 * m) - 1) for _ in range(8)]
        a = [rnd.randint(0, B ** m - 1) for _ in range(8)]
        b = [rnd.randint(0, B ** m - 1) for _ in range(8)]
        e = [rnd.randint(0, B ** 2 - 1) for _ in range(8)]
        # concurrent single-row submissions coalesce into shared buckets
        outs = await asyncio.gather(
            *[fe.submit("reduce", [x], v=v) for x in xs],
            *[fe.submit("modmul", [x], [y], v=v)
              for x, y in zip(a, b)],
            *[fe.submit("modexp", [x], [y], v=v)
              for x, y in zip(a, e)])
        assert [o[0] for o in outs[:8]] == [x % v for x in xs]
        assert [o[0] for o in outs[8:16]] == \
            [(x * y) % v for x, y in zip(a, b)]
        assert [o[0] for o in outs[16:]] == \
            [pow(x, y, v) for x, y in zip(a, e)]
        print(f"24 concurrent requests served exactly on {dev}\n")
        print(report.render_health(fe.healthz()))
        st = svc.telemetry.stats()
        print(f"\ncoalescing: {st['rows_true']} true rows in "
              f"{st['rows_padded']} padded "
              f"(waste {st['pad_waste']:.2f})")
        fams = merged_collect(fe.metrics.registry, svc.telemetry.registry)
        print(f"\nmerged metric export: {len(fams)} families "
              f"(first 12 lines):")
        for line in fe.metrics_lines()[:12]:
            print(f"  {line}")


async def chaos_smoke(dev) -> None:
    rnd = random.Random(7)

    # -- scenario 1: compile fault => ladder degradation ----------------
    # cuda_fused is poisoned at compile; traffic must fall to
    # cuda_batched with bit-identical divmod results.
    m = 2
    us = [rnd.randint(0, B ** m - 1) for _ in range(4)]
    vs = [rnd.randint(1, B ** m - 1) for _ in range(4)]
    div = BigintDivisionService(m_limbs=m, impl="cuda_fused",
                                batch_buckets=(2,), device=dev)
    inj = FaultInjector([FaultSpec(site="compile", impl="cuda_fused",
                                   kind="compile", times=0)], seed=7)
    pol = ServingPolicy(max_retries=3, backoff_base=0.001,
                        backoff_cap=0.01)
    async with AsyncFrontend(div, policy=pol, faults=inj) as fe:
        qs, rs = await fe.submit("divmod", us, vs)
        assert qs == [u // v for u, v in zip(us, vs)], "NOT bit-identical"
        assert rs == [u % v for u, v in zip(us, vs)], "NOT bit-identical"
        snap = fe.snapshot()
        health = snap["frontend"]["health"]
        assert health["quarantine"] == ["cuda_fused/b2/m2"], health
        plan = div.kernel_plans[2]
        assert plan.impl == "cuda_batched"
        assert plan.degraded_from == "cuda_fused"
        assert health["dropped"] == 0
        print("chaos 1 (compile fault): degraded "
              f"{plan.degraded_from} -> {plan.impl}, results exact, "
              f"quarantine={health['quarantine']}")

    # -- scenario 2: transient execute faults => retry-with-backoff ----
    # plus a deadline-expired request and an empty request, all while
    # normal traffic flows.
    m = 4
    arith = ModArithService(m_limbs=m, e_limbs=1, batch_buckets=(4,),
                            device=dev)
    v = rnd.randint(2, B ** m - 1)
    a = [rnd.randint(0, B ** m - 1) for _ in range(6)]
    b = [rnd.randint(0, B ** m - 1) for _ in range(6)]
    expected = [(x * y) % v for x, y in zip(a, b)]
    # the no-fault path agrees with the oracle
    assert ModArithService(m_limbs=m, e_limbs=1, batch_buckets=(4,),
                           device=dev).modmul(a, b, v) == expected
    inj = FaultInjector([FaultSpec(site="execute", op="modmul",
                                   times=2)], seed=7)
    async with AsyncFrontend(arith, policy=pol, faults=inj) as fe:
        got = await fe.submit("modmul", a, b, v=v)
        assert got == expected, "retried result NOT bit-identical"
        try:
            await fe.submit("reduce", [1, 2, 3], v=v, timeout=0.0)
            raise AssertionError("deadline did not fire")
        except E.DeadlineExceeded as exc:
            assert exc.completed == 0 and exc.total == 3
        assert await fe.submit("reduce", [], v=v) == []
        health = fe.healthz()
        assert health["retries"] == 2, health
        assert health["deadline_exceeded"] == 1
        assert health["dropped"] == 0
        lines = fe.metrics_lines()
        assert any(ln.startswith("queue_depth ") for ln in lines)
        assert any(ln.startswith("retries_total") for ln in lines)
        snap = fe.snapshot()
        assert snap["faults"]["fired_total"] == 2
        print("chaos 2 (transient + deadline): retries=2, results "
              "exact, typed DeadlineExceeded(0/3), 0 dropped")
        print()
        print(report.render_health(health))
    print("\nCHAOS SMOKE PASS")


def main(argv=None) -> None:
    args = parse_device(__doc__, argv, **{
        "--chaos-smoke": "inject faults and assert the robustness "
                         "contract"})
    asyncio.run(chaos_smoke(args.device) if args.chaos_smoke
                else demo(args.device))


if __name__ == "__main__":
    main()
