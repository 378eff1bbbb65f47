"""The port's telemetry additions against the JAX package's
(`repro/obs/telemetry.py`): `timer`, `merged_collect`, and `scope`,
which names each Refine iteration and fused stage in a `torch.profiler`
trace when profiling is on and changes no result and no launch count.
"""

import random
import time

import pytest
import torch

from repro.obs import telemetry as JT
from repro_torch.core import bigint as bi
from repro_torch.core import shinv as S
from repro_torch.obs import telemetry as T
from repro_torch.utils import launch_stats as LS

B = bi.BASE


def _fill(mod):
    """Two registries of mod's Registry with colliding and distinct
    families, filled alike."""
    a, b = mod.Registry(), mod.Registry()
    a.counter("requests_total", "calls", ("op",)).labels(op="divmod").inc(3)
    a.gauge("queue_depth", "depth").set(2)
    h = a.histogram("bucket_seconds", "wall", ("bucket",))
    h.labels(bucket=4).observe(0.002)
    h.labels(bucket=4).observe(0.5)
    b.counter("requests_total", "calls", ("op",)).labels(op="reduce").inc()
    b.counter("admitted_total", "admitted").inc(5)
    return a, b


def test_merged_collect_matches_jax():
    ours, theirs = T.merged_collect(*_fill(T)), JT.merged_collect(*_fill(JT))
    assert ours == theirs
    assert [f["name"] for f in ours] == sorted(f["name"] for f in ours)
    assert sum(f["name"] == "requests_total" for f in ours) == 2
    assert T.merged_collect() == JT.merged_collect() == []


def test_timer_matches_jax():
    for mod in (T, JT):
        with mod.timer() as t:
            time.sleep(0.01)
        assert 0.01 <= t.seconds < 1.0
        with pytest.raises(RuntimeError):
            with mod.timer() as t:
                raise RuntimeError
        assert t.seconds >= 0.0


def _divide():
    rnd = random.Random(0)
    m = 6
    us = [rnd.randrange(B ** m) for _ in range(3)]
    vs = [rnd.randrange(1, B ** 4) for _ in range(3)]
    t = lambda xs: bi.limbs_from_numpy(bi.batch_from_ints(xs, m), "cpu")
    return (t(us), t(vs)), [divmod(u, v) for u, v in zip(us, vs)]


def test_scope_is_a_noop_unless_profiling():
    assert not T.profiling_enabled()
    with T.scope("x") as s:
        assert s is None


def test_scope_names_refine_iterations_and_stages():
    """With profiling on, each Refine iteration and the fused stages are
    named ranges of the trace; the answer and the static profile's
    launches are those of a run with profiling off."""
    args, want = _divide()
    off = LS.trace_profile(S.divmod_batch, *args)
    T.set_profiling(True)
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            q, r = S.divmod_batch(*args)
        on = LS.trace_profile(S.divmod_batch, *args)
    finally:
        T.set_profiling(False)
    got = list(zip(bi.batch_to_ints(q), bi.batch_to_ints(r)))
    assert got == want
    names = {e.name for e in prof.events()}
    iters = S.refine_iters(6)
    assert {f"refine_iter_{i}" for i in range(iters)} <= names
    assert {"fused_step", "fused_correct"} <= names
    assert on["kernel_launches"] == off["kernel_launches"] == 0
