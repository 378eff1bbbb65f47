"""A traced window and its reduction: `torch.profiler` over one call of
the window, read back as device operations (kernels, copies, sets) and
host ranges (`record_function`: the services' `annotate` ranges and the
harness's own), in the profiler's clock.

The window is the span of the harness's "bench/window" range.  Busy
time is the union of the device operations inside it; an idle gap is a
stretch of it with none, named by the innermost host range open at the
gap's middle ("(none)" where no range is open)."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

WINDOW = "bench/window"
_DEVICE_KINDS = ("kernel", "concurrent_kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    """A kernel's name without its return type, signature and template
    arguments."""
    n = re.sub(r"^void\s+", "", name.strip())
    n = re.sub(r"^\(anonymous namespace\)::", "", n)
    return n.split("(")[0].split("<")[0].strip() or name


@dataclass
class Trace:
    start: int = 0                       # window, profiler clock (ns)
    end: int = 0
    device: list = field(default_factory=list)   # (name, kind, start, end)
    ranges: list = field(default_factory=list)   # (name, start, end)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def inside(self):
        """The device operations inside the window, clipped to it."""
        for name, kind, s, e in self.device:
            s, e = max(s, self.start), min(e, self.end)
            if e > s:
                yield name, kind, s, e

    def busy_intervals(self, kinds=None) -> list[tuple[int, int]]:
        spans = sorted((s, e) for _, k, s, e in self.inside()
                       if kinds is None or k in kinds)
        out: list[list[int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self, kinds=None) -> float:
        return sum(e - s for s, e in self.busy_intervals(kinds)) / 1e9

    def by_name(self, kinds=("kernel",)) -> dict[str, float]:
        """Device seconds per short name (kernels by default)."""
        out: dict[str, float] = {}
        for name, k, s, e in self.inside():
            if kinds is None or k in kinds:
                key = short_name(name)
                out[key] = out.get(key, 0.0) + (e - s) / 1e9
        return out

    def idle_gaps(self) -> dict[str, float]:
        """Idle seconds of the window by the host range open at each
        gap's middle."""
        gaps, t = [], self.start
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        ranges = sorted((r for r in self.ranges if r[0] != WINDOW),
                        key=lambda r: r[1])
        out: dict[str, float] = {}
        active: list = []
        i = 0
        for s, e in gaps:                 # in time order: one sweep
            mid = (s + e) // 2
            while i < len(ranges) and ranges[i][1] <= mid:
                active.append(ranges[i])
                i += 1
            active = [r for r in active if r[2] > mid]
            name = max(active, key=lambda r: r[1])[0] if active \
                else "(none)"
            out[name] = out.get(name, 0.0) + (e - s) / 1e9
        return out


def _kind(ev, annotations: set) -> str | None:
    """"kernel", "gpu_memcpy" or "gpu_memset" for a device operation,
    None for anything else (host events, and the device-side copies of
    host ranges, told apart by their names)."""
    kind = str(ev.activity_type()) if hasattr(ev, "activity_type") else ""
    if kind in _DEVICE_KINDS:
        kind = "kernel" if kind.endswith("kernel") else kind
    elif "annotation" in kind or not str(ev.device_type()).endswith("CUDA"):
        return None
    name = ev.name()
    if name in annotations:
        return None
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return kind if kind in _DEVICE_KINDS[2:] else "kernel"


def read(prof) -> Trace:
    """The window's Trace from a finished `torch.profiler.profile`."""
    tr = Trace()
    events = prof.profiler.kineto_results.events()
    annotations = {ev.name() for ev in events if ev.is_user_annotation()}
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        kind = _kind(ev, annotations)
        if kind is not None:
            tr.device.append((ev.name(), kind, s, e))
        elif ev.is_user_annotation() and not str(
                ev.device_type()).endswith("CUDA"):
            if ev.name() == WINDOW:
                tr.start, tr.end = s, e
            else:
                tr.ranges.append((ev.name(), s, e))
    return tr


def kinds(prof) -> dict[str, int]:
    """Events of a profile by (activity type, device type): what the
    trace held, for the run's log."""
    out: dict[str, int] = {}
    for ev in prof.profiler.kineto_results.events():
        kind = ev.activity_type() if hasattr(ev, "activity_type") else "-"
        key = f"{kind}/{ev.device_type()}"
        out[key] = out.get(key, 0) + 1
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The result line's breakdown: the device operations that took
    most time and the longest idle stretches by host range."""
    ops = sorted(tr.by_name(kinds=None).items(), key=lambda kv: -kv[1])
    gaps = sorted(tr.idle_gaps().items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops[:top]],
            "idle_gaps": [[k, v] for k, v in gaps[:top]]}
