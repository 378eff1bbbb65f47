"""CPU tests of the readers of the program's division spans: each of
`prologue_ms_per_call`, `refine_ms_per_call`, `refine_glue_ms_per_call`
and `finalize_ms_per_call` gives the expected ms per call on a
synthetic span log and traced window, and None where there is nothing
to read."""

from __future__ import annotations

import pytest

from bench.harness import base
from bench.harness import spec as SP
from bench.harness import trace as TR
from repro_torch.obs import telemetry as T

MS = 1_000_000
READERS = ("prologue_ms_per_call", "refine_ms_per_call",
           "refine_glue_ms_per_call", "finalize_ms_per_call")


def _division(t0: int, call: int, ids) -> list:
    """One replay's device spans from t0 (ns): prologue 10 ms, two
    Refine iterations of 30 ms each holding a 25 ms fused_step, the
    epilogue 4 ms and fused_correct 20 ms."""
    def span(name, a, b, parent):
        sid = next(ids)
        out.append(T.Span(name, t0 + a * MS, t0 + b * MS, parent, call, sid,
                          True))
        return sid

    out: list = []
    root = span("divmod", 0, 94, None)
    span("divmod/prologue", 0, 10, root)
    for i in range(2):
        it = span(f"refine_iter_{i}", 10 + 30 * i, 40 + 30 * i, root)
        span("fused_step", 15 + 30 * i, 40 + 30 * i, it)
    span("divmod/epilogue", 70, 74, root)
    span("fused_correct", 74, 94, root)
    return out


@pytest.fixture
def logged(monkeypatch):
    """A log of three replays (the first before the window) and a host
    span, and a run whose traced window holds the last two."""
    ids = iter(range(1, 1000))
    spans = (_division(0, 1, ids) + _division(200 * MS, 2, ids)
             + _division(300 * MS, 3, ids))
    spans.append(T.Span("exe/replay", 200 * MS, 400 * MS, None, 2, 999,
                        False))
    monkeypatch.setattr(T, "span_log", lambda: list(spans))
    return base.Run(trace=TR.Trace(start=150 * MS, end=500 * MS))


@pytest.mark.parametrize("name,want", [
    ("prologue_ms_per_call", 10.0), ("refine_ms_per_call", 60.0),
    ("refine_glue_ms_per_call", 10.0), ("finalize_ms_per_call", 24.0)])
def test_reader_on_a_synthetic_log(logged, name, want):
    assert SP.reader(name)(logged) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_spans_is_none(monkeypatch, name):
    read = SP.reader(name)
    run = base.Run(trace=TR.Trace(start=0, end=10 * MS))
    monkeypatch.setattr(T, "span_log", lambda: [])
    assert read(run) is None
    assert read(base.Run()) is None                  # untraced
    monkeypatch.delattr(T, "span_log")               # a program without it
    assert read(run) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_outside_the_window_is_none(logged, name):
    logged.trace = TR.Trace(start=500 * MS, end=600 * MS)
    assert SP.reader(name)(logged) is None
