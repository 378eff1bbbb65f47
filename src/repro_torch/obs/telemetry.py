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

`scope` (inside the computation: each Refine iteration, each fused
stage) and `annotate` (around a service's call) name ranges in a
`torch.profiler` trace and in NVTX (`torch.profiler.record_function`),
the counterparts of the JAX package's `scope` and `annotate`; both are
no-ops unless profiling is switched on with `set_profiling(True)`.  A
range is host-side only: it adds no kernel to a call or to a captured
CUDA graph, so launch counts stay exact.
"""

from __future__ import annotations

import contextlib
import time

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
# profiler ranges
# ---------------------------------------------------------------------------

_PROFILING = False


def set_profiling(enabled: bool) -> None:
    global _PROFILING
    _PROFILING = bool(enabled)


def profiling_enabled() -> bool:
    return _PROFILING


def annotate(name: str):
    """A named range around host code in a `torch.profiler` trace
    (`record_function`).  No-op unless profiling is switched on."""
    if not _PROFILING:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def scope(name: str):
    """A named range inside the computation (each Refine iteration, each
    fused stage), `record_function` as `annotate`.  No-op unless
    profiling is switched on."""
    if not _PROFILING:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
