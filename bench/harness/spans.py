"""The program's division spans inside a traced window, for the readers
of the "division phases" layer: the device spans of the span log
(`repro_torch.obs.telemetry.span_log`) that lie inside `bench/window`,
and the number of `divmod` spans among them, one a call."""

from __future__ import annotations


def in_window(run):
    """(spans, calls) of the run's traced window; None where the run was
    not traced, the program keeps no span log, or no `divmod` span lies
    in the window."""
    from repro_torch.obs import telemetry as T
    log = getattr(T, "span_log", None)
    if run.trace is None or log is None:
        return None
    spans = [s for s in log() if s.device and run.trace.start <= s.start_ns
             and s.end_ns <= run.trace.end]
    calls = sum(s.name == "divmod" for s in spans)
    return (spans, calls) if calls else None


def ms(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6
