"""Metrics core of the port: counters, gauges and histograms with
labeled series, a monotonic timer, and plain-data / line-protocol
export.

A copy of `repro/obs/telemetry.py` (the port imports nothing of the JAX
package).  Every owner (a service, a frontend) constructs its own
`Registry`; nothing is process-global.  Metrics are recorded on the
host around the calls that run on the device, and accept plain Python
numbers only: a tensor must be read back (`.item()`) by the caller, so
recording never hides a device synchronisation.

Label model: a metric is declared once with a fixed tuple of label
names; each distinct label-value assignment is one series
(`counter.labels(bucket=64).inc()`).  Export is deterministic (sorted by
metric name, then label values): `Registry.collect` (plain data) and
`Registry.to_lines` (`name{k=v,...} value`).

`scope` (inside the computation: a division's phases, each Refine
iteration, each fused stage) and `annotate` (around host code: a
service's call, a bucket executable's copies and replay) name spans,
the counterparts of the JAX package's `scope` and `annotate`.  Both
are no-ops unless profiling is switched on with `set_profiling(True)`;
then each opens a `torch.profiler.record_function` range and logs a
host span.  The one exception is a `scope` inside a `capturing` block,
while a bucket executable captures its CUDA graph: it records a device
mark (`kernels/marks.py`, one thread of
`csrc/marks.cu:span_mark_kernel` that stamps the card's clock into a
small ring on the card) as it opens and as it closes, profiling or
not, so that every replay of the graph times its spans; boundaries
with nothing captured between them share one mark.  Marks are not
launches: `kernels.build` counts none of them, so launch counts stay
exact.

Every span lands in one in-memory log (`span_log`), which keeps the
newest `LOG_DEPTH`: name, start and end in ns on `torch.profiler`'s
clock (the host's realtime clock, which its events carry), the
enclosing span, and a call id shared by the spans of one call (a
bucket executable's replay and its host spans, or one outermost
scope).  A replay's marks reach the log only if it was made with
profiling on.  They are decoded lazily: reading the log reads each live
ring once, which waits for the card.  A ring keeps its last `depth`
replays; older ones are counted in `spans_dropped`.  The log outlives
the executable that wrote it until it is read or reset
(`reset_span_log`): when an executable is gone, its replays are decoded
and its ring freed.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import weakref
from collections import deque
from typing import NamedTuple

import torch


def _coerce(value) -> float:
    """Plain numbers only: a tensor is refused, so a metric never reads
    a device value behind its caller's back."""
    if isinstance(value, torch.Tensor):
        raise TypeError("metrics take Python numbers; read the tensor "
                        "back first")
    return float(value)


class _Series:
    """One labeled series of a metric."""

    __slots__ = ("labels", "value")

    def __init__(self, labels: dict):
        self.labels = labels
        self.value = 0.0


class CounterSeries(_Series):
    def inc(self, amount=1) -> None:
        amount = _coerce(amount)
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += amount


class GaugeSeries(_Series):
    def set(self, value) -> None:
        self.value = _coerce(value)

    def inc(self, amount=1) -> None:
        self.value += _coerce(amount)

    def dec(self, amount=1) -> None:
        self.value -= _coerce(amount)


# Default latency boundaries (seconds): ~100 us .. ~100 s.
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                   1.0, 3.0, 10.0, 30.0, 100.0)


class HistogramSeries(_Series):
    __slots__ = ("labels", "value", "bounds", "counts", "count")

    def __init__(self, labels: dict, bounds: tuple):
        super().__init__(labels)
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last = +inf overflow
        self.count = 0
        self.value = 0.0                        # running sum

    def observe(self, value) -> None:
        value = _coerce(value)
        i = 0
        while i < len(self.bounds) and value > self.bounds[i]:
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.value += value

    @contextlib.contextmanager
    def time(self):
        """Host-clock timer: `with hist.time(): run()` (the body must
        wait for the device if device time is meant)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)


_KINDS = {"counter": CounterSeries, "gauge": GaugeSeries,
          "histogram": HistogramSeries}


class Metric:
    """A named family of series sharing one set of label names."""

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: tuple = (), buckets: tuple = DEFAULT_BUCKETS):
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self._series: dict[tuple, _Series] = {}

    def labels(self, **labelvalues) -> _Series:
        """The series for one label-value assignment (created on first
        use).  Label names must match the declaration exactly."""
        if tuple(sorted(labelvalues)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: got labels {sorted(labelvalues)}, "
                f"declared {sorted(self.labelnames)}")
        key = tuple(labelvalues[n] for n in self.labelnames)
        if key not in self._series:
            cls = _KINDS[self.kind]
            labels = dict(zip(self.labelnames, key))
            self._series[key] = (cls(labels, self.buckets)
                                 if self.kind == "histogram"
                                 else cls(labels))
        return self._series[key]

    # an unlabeled metric acts as its single series
    def _default(self) -> _Series:
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; call .labels()")
        return self.labels()

    def inc(self, amount=1):
        return self._default().inc(amount)

    def dec(self, amount=1):
        return self._default().dec(amount)

    def set(self, value):
        return self._default().set(value)

    def observe(self, value):
        return self._default().observe(value)

    def time(self):
        return self._default().time()

    def series(self) -> list[_Series]:
        return [self._series[k] for k in sorted(self._series)]


class Registry:
    """Instance-scoped metric registry.  Declaring a name twice returns
    the existing metric (and raises on a kind or label mismatch)."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def _declare(self, name, kind, help, labelnames, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-declared as {kind}"
                    f"{tuple(labelnames)}; was {m.kind}{m.labelnames}")
            return m
        m = Metric(name, kind, help, labelnames, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name, help="", labelnames=()) -> Metric:
        return self._declare(name, "counter", help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Metric:
        return self._declare(name, "gauge", help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Metric:
        return self._declare(name, "histogram", help, labelnames,
                             buckets=buckets)

    def get(self, name) -> Metric | None:
        return self._metrics.get(name)

    # -- export ----------------------------------------------------------

    def collect(self) -> list[dict]:
        """Deterministic plain-data dump of every series."""
        out = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = []
            for s in m.series():
                row = {"labels": s.labels, "value": s.value}
                if m.kind == "histogram":
                    row.update({"count": s.count, "sum": s.value,
                                "bounds": list(s.bounds),
                                "bucket_counts": list(s.counts)})
                    del row["value"]
                series.append(row)
            out.append({"name": name, "kind": m.kind, "help": m.help,
                        "series": series})
        return out

    def to_lines(self) -> list[str]:
        """`name{k=v,...} value` line protocol (histograms emit _count
        and _sum lines plus cumulative le-bucket lines)."""
        def tag(name, lbl):
            return f"{name}{{{lbl}}}" if lbl else name

        lines = []
        for fam in self.collect():
            for s in fam["series"]:
                lbl = ",".join(f"{k}={v}" for k, v in
                               sorted(s["labels"].items()))
                if fam["kind"] == "histogram":
                    cum = 0
                    for bound, n in zip(s["bounds"] + [float("inf")],
                                        s["bucket_counts"]):
                        cum += n
                        blbl = (lbl + "," if lbl else "") + f"le={bound}"
                        lines.append(
                            f"{tag(fam['name'] + '_bucket', blbl)} {cum}")
                    lines.append(f"{tag(fam['name'] + '_count', lbl)} "
                                 f"{s['count']}")
                    lines.append(f"{tag(fam['name'] + '_sum', lbl)} "
                                 f"{s['sum']}")
                else:
                    v = s["value"]
                    lines.append(f"{tag(fam['name'], lbl)} "
                                 f"{int(v) if v == int(v) else v}")
        return lines


def merged_collect(*registries) -> list[dict]:
    """One deterministic dump across several registries (a frontend's
    queue and failure families beside its service's request families):
    the families concatenated in name-sorted order; name collisions
    stay separate entries (distinct owners are distinct sources)."""
    fams = [fam for reg in registries for fam in reg.collect()]
    return sorted(fams, key=lambda f: f["name"])


def merged_lines(*registries) -> list[str]:
    """Line-protocol export across several registries (a frontend's
    queue and failure families beside its service's request
    families)."""
    out = []
    for reg in registries:
        out.extend(reg.to_lines())
    return out


@contextlib.contextmanager
def timer():
    """Standalone monotonic timer: `with timer() as t: ...; t.seconds`
    (host clock; the body must wait for the device where it matters)."""
    class _T:
        seconds = 0.0
    t = _T()
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        t.seconds = time.perf_counter() - t0


# ---------------------------------------------------------------------------
# spans: profiler ranges, graph marks and the span log
# ---------------------------------------------------------------------------

_PROFILING = False


def set_profiling(enabled: bool) -> None:
    global _PROFILING
    _PROFILING = bool(enabled)


def profiling_enabled() -> bool:
    return _PROFILING


class Span(NamedTuple):
    """One logged span; times in ns on the profiler's clock."""
    name: str
    start_ns: int
    end_ns: int
    parent: int | None     # id of the enclosing span of the same kind
    call: int              # shared by the spans of one call
    id: int
    device: bool           # marked on the card (else timed on the host)


LOG_DEPTH = 1 << 16               # spans the log keeps, the newest
_ids = itertools.count(1)
_calls = itertools.count(1)
_local = threading.local()        # this thread's open spans and capture
_log_lock = threading.Lock()
_records: deque = deque(maxlen=LOG_DEPTH)
_sources: list = []               # the live graphs' marks
_dropped = 0


def new_call() -> int:
    """A fresh call id (a bucket executable takes one per call)."""
    return next(_calls)


def _stack() -> list:
    """This thread's open spans: (id, call, True) for a host span,
    (tape index, None, False) for a span being captured."""
    return _local.__dict__.setdefault("stack", [])


def _log(spans, dropped: int = 0) -> None:
    global _dropped
    with _log_lock:
        _records.extend(spans)
        _dropped += dropped


@contextlib.contextmanager
def _host_span(name: str, call: int | None):
    """A `record_function` range and a host span in the log: its parent
    is the innermost open host span, and it takes `call`, else the call
    of the innermost open span that has one, else a new one."""
    stack = _stack()
    parent = next((s[0] for s in reversed(stack) if s[2]), None)
    if call is None:
        call = next((s[1] for s in reversed(stack) if s[1] is not None),
                    None) or new_call()
    sid = next(_ids)
    stack.append((sid, call, True))
    t0 = time.time_ns()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        t1 = time.time_ns()
        stack.pop()
        _log([Span(name, t0, t1, parent, call, sid, False)])


class GraphMarks:
    """The marks of one captured CUDA graph: `ring`
    (`kernels/marks.py:Ring`, the last `ring.depth` replays' stamps on
    the card), the tape made at capture (each span's name, parent and
    its two mark indices) and the call ids of the replays made with
    profiling on that the log has not decoded yet.  `capturing(marks)`
    fills the tape, a mark at each scope boundary, shared by boundaries
    with nothing captured between them; `start` gives the ring its
    width and ties the marks to the executable that replays them."""

    def __init__(self, ring):
        self.ring = ring
        self.tape: list[list] = []
        self.width = 0
        self.rows = 0                       # replays enqueued
        self.calls: deque = deque(maxlen=ring.depth)  # (row, call)
        self.lost = 0                       # profiled replays pushed out
        self._tail = 0                      # the capture's tail after
        self._lock = threading.Lock()       # the last mark

    def _mark(self) -> int:
        """The mark of this boundary: the last one where nothing was
        captured since (the capture's tail is still its node), else a
        new mark node."""
        if self._tail and self.ring.tail() == self._tail:
            return self.width - 1
        self.ring.mark(self.width)
        self._tail = self.ring.tail()
        self.width += 1
        return self.width - 1

    @contextlib.contextmanager
    def _span(self, name: str):
        stack = _stack()
        parent = next((s[0] for s in reversed(stack) if not s[2]), None)
        i = len(self.tape)
        self.tape.append([name, parent, self._mark(), None])
        stack.append((i, None, False))
        try:
            with (torch.profiler.record_function(name) if _PROFILING
                  else contextlib.nullcontext()):
                yield
        finally:
            stack.pop()
            self.tape[i][3] = self._mark()

    def start(self, owner) -> "GraphMarks | None":
        """After the capture: the ring sized to the tape's marks, and
        the marks in the log's sources until `owner` is gone (None
        where the graph made no mark)."""
        if not self.width:
            return None
        self.ring.allocate(self.width)
        with _log_lock:
            _sources.append(self)
        weakref.finalize(owner, _retire, self).atexit = False
        return self

    def replayed(self, call: int) -> None:
        """Count one replay enqueued; with profiling on, keep its call
        id for the log."""
        with self._lock:
            if _PROFILING:
                if len(self.calls) == self.calls.maxlen:
                    self.lost += 1
                self.calls.append((self.rows, call))
            self.rows += 1

    def pending(self) -> int:
        with self._lock:
            return len(self.calls) + self.lost

    def skip(self) -> None:
        with self._lock:
            self.calls.clear()
            self.lost = 0

    def decode(self) -> tuple[list[Span], int]:
        """The spans of the profiled replays not decoded yet (the ring
        read once, which waits for the card) and the count of those
        the ring no longer holds."""
        with self._lock:
            pending, dropped = list(self.calls), self.lost
            self.calls.clear()
            self.lost = 0
        if not pending:
            return [], dropped
        stamps = self.ring.read()
        out = []
        for r, call in pending:
            row = stamps[r % self.ring.depth]
            if not bool((row[:, 2] == r).all()):
                dropped += 1
                continue
            t = row[:, 0].tolist()
            ids: dict = {}
            for i, (name, parent, a, b) in enumerate(self.tape):
                ids[i] = next(_ids)
                out.append(Span(name, t[a], t[b], ids.get(parent), call,
                                ids[i], True))
        return out, dropped


def _retire(marks: GraphMarks) -> None:
    """The executable of `marks` is gone: its profiled replays go into
    the log, and its ring leaves the sources.  Inside a capture on this
    thread, where a wait for the card is refused, they count as
    dropped."""
    with _log_lock:
        if marks in _sources:
            _sources.remove(marks)
    if not marks.pending():
        return
    if getattr(_local, "capture", None) is None and not (
            marks.ring.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        _log(*marks.decode())
    else:
        _log([], marks.pending())


@contextlib.contextmanager
def capturing(marks: GraphMarks):
    """Inside a CUDA graph capture on this thread: every `scope` marks
    into `marks`."""
    prev = getattr(_local, "capture", None)
    _local.capture = marks
    try:
        yield
    finally:
        _local.capture = prev


def span_log() -> list[Span]:
    """The log since the last reset, in no set order: the host spans,
    and the device spans of every replay made with profiling on,
    decoded now (each live ring read once)."""
    with _log_lock:
        sources = list(_sources)
    for src in sources:
        _log(*src.decode())
    with _log_lock:
        return list(_records)


def spans_dropped() -> int:
    """Replays made with profiling on whose marks were lost before the
    log read them (their ring had moved on), since the last reset."""
    return _dropped


def reset_span_log() -> None:
    """Empty the log: what was logged or replayed so far is dropped,
    uncounted; live executables go on logging their next replays."""
    global _dropped
    with _log_lock:
        _records.clear()
        _dropped = 0
        for src in _sources:
            src.skip()


def annotate(name: str, call: int | None = None):
    """A named host span around host code: a `torch.profiler` range
    (`record_function`) and a host span in the log, under `call` (by
    default the call of the enclosing span, or a new one).  No-op
    unless profiling is switched on."""
    if not _PROFILING:
        return contextlib.nullcontext()
    return _host_span(name, call)


def scope(name: str):
    """A named span inside the computation (a division's phases, each
    Refine iteration, each fused stage).  Inside a `capturing` block:
    a device mark as it opens and as it closes, recorded in the graph.
    Otherwise a no-op unless profiling is switched on, and then a host
    span as `annotate`'s."""
    marks = getattr(_local, "capture", None)
    if marks is not None:
        return marks._span(name)
    if not _PROFILING:
        return contextlib.nullcontext()
    return _host_span(name, None)
