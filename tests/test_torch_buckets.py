"""The port's bucket executables on the CPU: `batching.CompiledBuckets`
(hits and misses, racing first uses, failed builds, the compile fault
site), `kernels.build.recording` (the launch scopes a graph capture
records into), the services' static profiles
(`utils/launch_stats.py:trace_profile`, `profile_bucket`, `snapshot()`)
and `obs/report.py` held to the JAX package's `repro/obs/report.py`.

On the CPU an executable is the eager function and nothing launches, so
every profile has `kernel_launches == 0`; the graphs themselves are
tested on the card (tests/test_torch_cuda.py).
"""

import json
import random
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from repro.obs import report as JR
from repro_torch.core import bigint as bi
from repro_torch.core import shinv as S
from repro_torch.kernels import build
from repro_torch.kernels import ops as K
from repro_torch.obs import costmodel as CM
from repro_torch.obs import report as R
from repro_torch.serving import batching as BT
from repro_torch.serving import errors as E
from repro_torch.serving.bigint_service import BigintDivisionService
from repro_torch.serving.faults import FaultInjector, FaultSpec
from repro_torch.serving.modexp_service import ModArithService
from repro_torch.utils import launch_stats as LS


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


def _exe(impl="cuda_fused"):
    return BT.Executable(lambda x: x + 1, (torch.zeros(2, 3),),
                         BT.kernel_plan(impl))


# ---------------------------------------------------------------------------
# CompiledBuckets
# ---------------------------------------------------------------------------

def test_compiled_buckets_hits_misses_and_current_plan():
    cache = BT.CompiledBuckets()
    builds = []

    def build_once(impl):
        builds.append(impl)
        return _exe(impl)

    a = cache.use("divmod", 4, "cuda_fused", "cuda_fused",
                  lambda: build_once("cuda_fused"))
    assert cache.use("divmod", 4, "cuda_fused", "cuda_fused",
                     lambda: build_once("x")) is a
    b = cache.use("divmod", 4, "cuda_batched", "cuda_fused",
                  lambda: build_once("cuda_batched"))
    assert b is not a and builds == ["cuda_fused", "cuda_batched"]
    assert (cache.misses, cache.hits, len(cache)) == (2, 1, 2)
    assert cache.current[4] == BT.kernel_plan("cuda_batched")._replace(
        degraded_from="cuda_fused")
    cache.use("divmod", 4, "cuda_fused", "cuda_fused", lambda: None)
    assert cache.current[4] == BT.kernel_plan("cuda_fused")


def test_compiled_buckets_racing_first_uses_build_once():
    cache = BT.CompiledBuckets()
    builds = []
    start = threading.Barrier(8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def build_slowly():
        builds.append(1)
        return _exe()

    def worker(i):
        start.wait(timeout=30)
        return cache.use("modmul", 8, "blocked", "blocked", build_slowly)

    try:
        with ThreadPoolExecutor(max_workers=8) as pool:
            got = list(pool.map(worker, range(8)))
    finally:
        sys.setswitchinterval(old)
    assert len(builds) == 1 and all(g is got[0] for g in got)
    assert (cache.misses, cache.hits) == (1, 7)


def test_compiled_buckets_failed_build_caches_nothing():
    cache = BT.CompiledBuckets()

    def fail():
        raise RuntimeError("build failed")

    with pytest.raises(RuntimeError):
        cache.use("reduce", 2, "cuda_pairs", "cuda_pairs", fail)
    assert len(cache) == 0 and cache.current == {} and cache.misses == 1
    cache.use("reduce", 2, "cuda_pairs", "cuda_pairs", _exe)
    assert len(cache) == 1 and cache.misses == 2


@pytest.mark.parametrize("times", [1, 0])
def test_compile_fault_fires_once_per_key_before_the_build(times):
    """The fault site fires on a miss, before the build; a fault caches
    nothing, so the key faults again (times=0: every time) or builds
    (times=1: the next miss); a hit never fires it."""
    inj = FaultInjector([FaultSpec(site="compile", kind="compile",
                                   times=times)])
    cache = BT.CompiledBuckets()
    built = []

    def build_it():
        built.append(1)
        return _exe()

    def use(bucket):
        return cache.use("divmod", bucket, "cuda_fused", "cuda_fused",
                         build_it, lambda **kw: inj.fire("compile", **kw))

    with pytest.raises(E.CompileFault):
        use(2)
    assert built == []
    if times == 1:
        use(2)
        use(2)
        use(4)
        assert (len(built), inj.fired_total()) == (2, 1)
    else:
        with pytest.raises(E.CompileFault):
            use(2)
        assert built == [] and inj.fired_total() == 2


def test_executable_on_the_cpu_is_the_eager_function():
    u = torch.tensor([[5, 0], [7, 1]], dtype=torch.int32)
    v = torch.tensor([[2, 0], [3, 0]], dtype=torch.int32)
    exe = BT.Executable(S.divmod_batch, (torch.zeros_like(u),
                                         torch.ones_like(v)),
                        BT.kernel_plan())
    assert exe.graph is None and exe.launches == {}
    assert exe.capture_seconds is None and exe.memory_bytes is None
    q, r = exe(u, v)
    q0, r0 = S.divmod_batch(u, v)
    assert torch.equal(q, q0) and torch.equal(r, r0)


# ---------------------------------------------------------------------------
# launch recording scopes
# ---------------------------------------------------------------------------

def test_recording_scopes_nest_and_capture_stays_out_of_the_counts():
    build.reset_launch_counts()
    with build.recording() as outer:
        build.count("powdiff")
        with build.recording(capture=True) as cap:
            build.count("update", 2)
        with build.recording() as inner:
            build.count("correct")
    assert outer == {"powdiff": 1, "update": 2, "correct": 1}
    assert cap == {"update": 2} and inner == {"correct": 1}
    assert build.launch_counts() == {"powdiff": 1, "correct": 1}
    build.count_all(cap)                        # a replay of the capture
    build.count_all(cap)
    assert build.launch_counts() == {"powdiff": 1, "correct": 1,
                                     "update": 4}
    build.reset_launch_counts()


def test_recording_scopes_are_per_thread():
    build.reset_launch_counts()
    start = threading.Barrier(4)

    def worker(i):
        start.wait(timeout=30)
        with build.recording(capture=i % 2 == 0) as rec:
            for _ in range(200):
                build.count(f"k{i}")
        return rec

    with ThreadPoolExecutor(max_workers=4) as pool:
        recs = list(pool.map(worker, range(4)))
    assert recs == [{f"k{i}": 200} for i in range(4)]
    assert build.launch_counts() == {"k1": 200, "k3": 200}
    build.reset_launch_counts()


def test_trace_profile_counts_do_not_depend_on_the_data():
    m = 5
    rnd = random.Random(5)
    fill_u = torch.zeros(3, m, dtype=torch.int32)
    fill_v = fill_u.clone()
    fill_v[:, 0] = 1
    u = bi.limbs_from_numpy(bi.batch_from_ints(
        [rnd.randint(0, B ** m - 1) for _ in range(3)], m), "cpu")
    v = bi.limbs_from_numpy(bi.batch_from_ints([7, 0, B ** 4], m), "cpu")
    a = LS.trace_profile(S.divmod_batch, fill_u, fill_v)
    b = LS.trace_profile(S.divmod_batch, u, v)
    assert a == b and a["kernel_launches"] == 0
    assert a["total_ops"] == a["glue_ops"] > 0


# ---------------------------------------------------------------------------
# the services' static profiles
# ---------------------------------------------------------------------------

def _div(m=4, impl=None, buckets=(2, 4)):
    return BigintDivisionService(m_limbs=m, batch_buckets=buckets,
                                 device="cpu", impl=impl)


def _mod(m=3, impl=None, buckets=(2,), e_limbs=1):
    return ModArithService(m_limbs=m, e_limbs=e_limbs,
                           batch_buckets=buckets, device="cpu", impl=impl)


@pytest.mark.parametrize("impl", ["cuda_fused", "cuda_pairs"])
def test_division_service_static_profile(impl):
    a, b = _div(impl=impl), _div(impl=impl)
    prof = a.profile_bucket(2)
    assert set(prof) == {"divmod"}
    assert prof["divmod"]["kernel_launches"] == 0
    assert a.stats()["bucket_compiles"] == 1
    assert b.divide([10 ** 9, 7, 3], [12345, 0, 2]) == (
        [10 ** 9 // 12345, 0, 1], [10 ** 9 % 12345, 7, 1])
    snap = b.snapshot()
    assert snap["buckets"][4]["static"] == prof      # same shape, m
    assert snap["buckets"][4]["plan"]["impl"] == impl
    assert snap["device"] == "cpu"
    assert b.static_profiles == {4: prof}
    a.divide([1, 2], [1, 1])
    assert a.stats()["bucket_reuses"] == 1


def test_modarith_service_static_profiles():
    a, b = _mod(), _mod()
    v = 1000003
    for op in ("reduce", "modmul", "modexp"):
        prof = a.profile_bucket(op, 2)[op]
        assert prof["kernel_launches"] == 0 and prof["glue_ops"] > 0
    assert a.stats()["bucket_compiles"] == 3
    assert b.modmul([7, 8], [9, 10], v) == [63, 80]
    assert b.reduce([v + 5], v) == [5]
    assert b.modexp([3], [5], v) == [243]
    assert b.snapshot()["buckets"][2]["static"] == \
        a.snapshot()["buckets"][2]["static"]
    pre = b.snapshot()["precompute"]
    assert pre["static"] == a.profile_bucket("precompute", 1)["precompute"]
    assert pre["plan"]["impl"] == "cuda_fused"
    # the precompute's executable is not a request bucket
    assert b.stats()["bucket_compiles"] == 3
    assert (b.ctx_misses, b.ctx_hits) == (1, 2)
    with pytest.raises(E.InvalidRequest):
        a.profile_bucket("divmod", 2)


def test_static_profile_glue_depends_on_the_width():
    narrow, wide = _div(m=4), _div(m=40)
    assert narrow.profile_bucket(2)["divmod"]["glue_ops"] < \
        wide.profile_bucket(2)["divmod"]["glue_ops"]


# ---------------------------------------------------------------------------
# obs/report.py against the JAX package's
# ---------------------------------------------------------------------------

ROWS = [{"bits": 32768, "batch": 256, "impl": "cuda_fused", "ms": 1.5,
         "exact": True, "launches": 27},
        {"bits": 4096, "batch": 8, "impl": "blocked", "ms": None,
         "exact": False, "launches": 0}]


@pytest.mark.parametrize("columns,title", [
    (None, None), (["impl", "bits", "ms"], "cells"),
    (["launches", "exact", "missing"], "t")])
def test_render_table_matches_jax(columns, title):
    assert R.render_table(ROWS, columns, title) == \
        JR.render_table(ROWS, columns, title)
    assert R.render_table([], columns, title) == \
        JR.render_table([], columns, title)


@pytest.mark.parametrize("health", [
    {"status": "ok", "accepting": True, "ready": True, "queue_depth": 0,
     "dropped": 0, "quarantine": []},
    {"status": "degraded", "accepting": True, "ready": False,
     "queued_items": 12, "inflight": 3, "retries": 2,
     "quarantine": ["cuda_fused/b4/m4"],
     "breakers": {"cuda_fused/b4/m4": "open", "blocked/b4/m4": "closed",
                  "cuda_pairs/b2/m4": "half_open"}},
    {}])
def test_render_health_matches_jax(health):
    assert R.render_health(health) == JR.render_health(health)


def test_merge_json_matches_jax(tmp_path):
    assert R.BENCH_KEY == JR.BENCH_KEY
    ours, theirs = tmp_path / "a.json", tmp_path / "b.json"
    for path, mod in ((ours, R), (theirs, JR)):
        mod.merge_json(str(path), ROWS)
        mod.merge_json(str(path), [{"bits": 4096, "batch": 8,
                                    "impl": "blocked", "ms": 2.25},
                                   {"bits": 2048, "batch": 1,
                                    "impl": "cuda_pairs", "ms": 0.5}])
    assert ours.read_text() == theirs.read_text()
    assert [r["bits"] for r in json.loads(ours.read_text())] == \
        [2048, 4096, 32768]


def _snapshots(service, m, impl, ops, buckets=(2, 8), e_limbs=None):
    """A port snapshot on the card and the matching JAX one: every
    measured launch count equal to the cost model's."""
    jimpl = K.JAX_IMPLS[impl]
    port = {"service": service, "m_limbs": m, "impl": impl,
            "device": "cuda", "buckets": {}}
    jax = {"service": service, "m_limbs": m, "impl": jimpl, "buckets": {}}
    if e_limbs is not None:
        port.update(e_limbs=e_limbs, window_bits=4)
        jax.update(e_limbs=e_limbs, window_bits=4)
    for b in buckets:
        pst, jst = {}, {}
        for i, op in enumerate(ops):
            n = CM.model_launches(op, m, impl, e_bits=16 * (e_limbs or 1))
            # the port's divmod also launches its set-up, JAX's does not
            pn = n + (CM.prologue_launches(impl) if op == "divmod" else 0)
            pst[op] = {"kernel_launches": pn, "glue_ops": 100 + i,
                       "total_ops": 100 + i + pn}
            jst[op] = {"pallas_launches": n, "runtime_pallas_launches": n,
                       "xla_eqns": 100 + i, "total_eqns": 500}
        port["buckets"][b] = {"static": pst}
        jax["buckets"][b] = {"static": jst}
    return port, jax


@pytest.mark.parametrize("impl", K.IMPLS)
@pytest.mark.parametrize("service,m,ops,e_limbs", [
    ("bigint_division", 2048, ("divmod",), None),
    ("modarith", 26, ("reduce", "modmul", "modexp"), 2)])
def test_measured_vs_model_matches_jax(impl, service, m, ops, e_limbs):
    port, jax = _snapshots(service, m, impl, ops, e_limbs=e_limbs)
    rows, jrows = R.measured_vs_model(port), JR.measured_vs_model(jax)
    assert len(rows) == len(jrows) == 2 * len(ops)
    for r, j in zip(rows, jrows):
        assert K.JAX_IMPLS[r["impl"]] == j["impl"]
        assert r["device"] == "cuda"
        for k in ("bucket", "op", "m_limbs", "iters", "match"):
            assert r[k] == j[k], k
        assert r["measured_launches"] == \
            j["measured_launches"] + r["prologue_launches"]
        assert r["prologue_launches"] == (
            CM.prologue_launches(impl) if r["op"] == "divmod" else 0)
        assert r["glue_ops"] == j["xla_eqns"]
        if r["op"] == "modexp":
            # the port counts modexp's launches; JAX leaves them to scan
            assert j["model_launches"] is None
            assert r["model_launches"] == CM.modexp_launches(
                16 * e_limbs, 4, impl)
        else:
            assert r["model_launches"] == j["model_launches"]
    assert all(r["match"] for r in rows)
    text = R.render_measured_vs_model(port)
    assert "device=cuda" in text and "False" not in text


def test_measured_vs_model_flags_a_mismatch_and_the_cpu():
    port, _ = _snapshots("bigint_division", 2048, "cuda_fused", ("divmod",))
    port["buckets"][2]["static"]["divmod"]["kernel_launches"] = 26
    rows = R.measured_vs_model(port)
    assert [r["match"] for r in rows] == [False, True]
    port["device"] = "cpu"
    rows = R.measured_vs_model(port)
    assert all(r["match"] and r["model_launches"] is None for r in rows)


def test_report_renders_both_services_on_the_cpu():
    div, mod = _div(), _mod()
    div.divide([10, 11, 12], [3, 4, 5])
    mod.modmul([2], [3], 7)
    for snap, ops in ((div.snapshot(), {"divmod"}),
                      (mod.snapshot(), {"modmul", "precompute"})):
        rows = R.measured_vs_model(snap)
        assert {r["op"] for r in rows} == ops
        assert all(r["device"] == "cpu" and r["measured_launches"] == 0
                   and r["model_launches"] is None and r["match"]
                   for r in rows)
        assert "device=cpu" in R.render_measured_vs_model(snap)
    pre = [r for r in R.measured_vs_model(mod.snapshot())
           if r["op"] == "precompute"]
    assert pre[0]["iters"] == CM.precompute_iters(3) and pre[0]["bucket"] == 1
