"""The port's telemetry additions against the JAX package's
(`repro/obs/telemetry.py`): `timer`, `merged_collect`, and `scope`,
which names each Refine iteration and fused stage in a `torch.profiler`
trace when profiling is on and changes no result and no launch count;
and the span log: a division's span tree as host spans on the CPU, and
as a captured tape of marks whose ring keeps its last replays and
leaves the log's sources with its executable.
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


def _spans_of(spans, call):
    return {s.id: s for s in spans if s.call == call}


def _check_division_tree(spans, m):
    """One division's spans: the named tree, nested in time."""
    by_name: dict = {}
    for sp in spans.values():
        by_name.setdefault(sp.name, []).append(sp)
    iters = S.refine_iters(m)
    assert set(by_name) == ({"divmod", "divmod/prologue", "divmod/epilogue",
                             "fused_step", "fused_correct"}
                            | {f"refine_iter_{i}" for i in range(iters)})
    assert all(len(v) == 1 for k, v in by_name.items() if k != "fused_step")
    root = by_name["divmod"][0]
    assert root.parent is None
    for sp in spans.values():
        if sp is root:
            continue
        up = spans[sp.parent]
        assert up.name == ("divmod" if sp.name != "fused_step"
                           else up.name)
        assert up.start_ns <= sp.start_ns <= sp.end_ns <= up.end_ns
    steps = {spans[s.parent].name for s in by_name["fused_step"]}
    assert len(by_name["fused_step"]) == iters
    assert steps == {f"refine_iter_{i}" for i in range(iters)}
    order = ["divmod/prologue"] + [f"refine_iter_{i}" for i in range(iters)] \
        + ["divmod/epilogue", "fused_correct"]
    starts = [by_name[n][0].start_ns for n in order]
    assert starts == sorted(starts)


def test_cpu_divmod_logs_the_division_span_tree():
    """Under profiling a CPU divmod logs host spans: divmod over its
    prologue, refine_iters(m) iterations each with one fused_step child,
    the epilogue and fused_correct, under one call id per call."""
    args, want = _divide()
    T.reset_span_log()
    T.set_profiling(True)
    try:
        for _ in range(2):
            q, r = S.divmod_batch(*args)
    finally:
        T.set_profiling(False)
    assert list(zip(bi.batch_to_ints(q), bi.batch_to_ints(r))) == want
    spans = T.span_log()
    assert not any(s.device for s in spans)
    calls = sorted({s.call for s in spans})
    assert len(calls) == 2
    for call in calls:
        _check_division_tree(_spans_of(spans, call), 6)
    T.reset_span_log()
    assert T.span_log() == [] and T.spans_dropped() == 0


def test_scope_logs_nothing_unless_profiling():
    args, _ = _divide()
    T.reset_span_log()
    S.divmod_batch(*args)
    with T.scope("x"), T.annotate("y"):
        pass
    assert T.span_log() == []


def test_no_fused_barrett_range_remains():
    """The Barrett core opens no span: with marks, it would add two
    nodes to each of a modexp ladder's reductions."""
    from repro_torch.kernels import ops as K
    w = 10
    x = torch.zeros(2, w, dtype=torch.int32)
    mu, v = torch.zeros(w, dtype=torch.int32), torch.zeros(w, dtype=torch.int32)
    v[0] = 7
    T.reset_span_log()
    T.set_profiling(True)
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            K.fused_barrett(x, mu, v, h=w)
    finally:
        T.set_profiling(False)
    assert T.span_log() == []
    assert "fused_barrett" not in {e.name for e in prof.events()}


class _Owner:
    """Stands in for the executable that owns a ring."""


class _Ring:
    """`kernels/marks.py:Ring` in host memory, the host's clock for the
    card's: mark 0 starts a row, the others stamp it.  It sees no
    capture, so each tail is new and no mark is shared."""

    def __init__(self, depth):
        self.device, self.depth = torch.device("cpu"), depth
        self.rows, self.stamps, self.reads, self.tails = 0, None, 0, 0

    def tail(self):
        self.tails += 1
        return self.tails

    def allocate(self, width):
        self.stamps = torch.full((self.depth, width, 3), -1,
                                 dtype=torch.int64)

    def mark(self, j):
        if self.stamps is None:                 # a capture: nothing runs
            return
        if j == 0:
            self.rows += 1
        row = self.rows - 1
        self.stamps[row % self.depth, j] = torch.tensor(
            [time.time_ns(), j, row])

    def read(self):
        self.reads += 1
        return self.stamps.clone()


def _captured(depth):
    """A CPU divmod captured under marks into a `_Ring` of `depth`."""
    args, want = _divide()
    marks = T.GraphMarks(_Ring(depth))
    with T.capturing(marks):
        q, r = S.divmod_batch(*args)
    assert list(zip(bi.batch_to_ints(q), bi.batch_to_ints(r))) == want
    return marks


def _replay(marks, calls):
    for j in range(marks.width):
        marks.ring.mark(j)
    calls.append(T.new_call())
    marks.replayed(calls[-1])


def test_captured_marks_and_the_ring_keeps_its_last_replays():
    """A capture of a CPU divmod tapes the span tree with a mark at
    each scope boundary where the ring's tail moved (here every one:
    4 * refine_iters + 8).  A ring of depth R after
    R + 5 replays with profiling on keeps the last R and counts 5
    dropped; the log outlives its owner until it is read."""
    depth = 4
    T.reset_span_log()
    marks = _captured(depth)
    iters = S.refine_iters(6)
    assert len(marks.tape) == 4 + 2 * iters
    assert marks.width == 2 * len(marks.tape)
    owner = _Owner()
    marks = marks.start(owner)
    calls: list = []
    T.set_profiling(True)
    try:
        for _ in range(depth + 5):
            _replay(marks, calls)
    finally:
        T.set_profiling(False)
    spans = T.span_log()
    assert T.spans_dropped() == 5
    assert sorted({s.call for s in spans}) == calls[5:]
    assert all(s.device for s in spans)
    for call in calls[5:]:
        _check_division_tree(_spans_of(spans, call), 6)
    del owner
    assert marks not in T._sources
    assert len(T.span_log()) == len(spans)
    T.reset_span_log()


def test_a_dropped_executable_leaves_its_replays_and_no_ring():
    """When its owner is gone, a ring's replays made with profiling on
    are decoded into the log and the ring leaves the log's sources;
    replays made with profiling off never read the ring."""
    T.reset_span_log()
    before = len(T._sources)
    owners, rings, calls = [], [], []
    for profiled in (True, False, True):
        owner = _Owner()
        marks = _captured(4).start(owner)
        T.set_profiling(profiled)
        try:
            for _ in range(2):
                _replay(marks, calls if profiled else [])
        finally:
            T.set_profiling(False)
        owners.append(owner)
        rings.append(marks.ring)
    assert len(T._sources) == before + 3
    del owner, marks
    owners.clear()
    assert len(T._sources) == before
    assert [r.reads for r in rings] == [1, 0, 1]
    spans = T.span_log()
    assert sorted({s.call for s in spans}) == calls
    assert T.spans_dropped() == 0
    T.reset_span_log()
