"""What every runner shares: the `Run` record the metric readers take,
the `Runner` base class, and a profiled window.

A runner is a module `bench/runners/<entry>.py`, found by the `entry`
of a traffic mix, with a class `Runner(base.Runner)`.  It builds
everything in `setup(mark_setup)`, runs one window in
`window(seconds, profiled)`, copies what it checks to the host and frees
the program's state in `release()`, may put the control's answers in
the program's place in `control()`, and compares a sample of what the
window produced with `bench/ref` in `check()`: {name: (value, limit)}
for each number compared, and {"_<name>": count} for what was checked.
Everything a metric reads lands in `Run`."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

from bench.harness import trace as TR


@dataclass
class Run:
    """What one run measured; the metric readers take it."""
    setup_s: float = 0.0
    window_s: float = 0.0
    done: int = 0                  # operations answered in the window
    attempted: int = 0
    failed: int = 0
    calls: int = 0                 # executable calls in the window
    launches: dict = field(default_factory=dict)    # counter deltas
    port_kernels: set = field(default_factory=set)  # "<name>_kernel"
    work: tuple | None = None      # (products, bytes) answered
    trace: TR.Trace | None = None


def profiled(torch, body) -> TR.Trace:
    """Run body() (which ends in a synchronise) inside a "bench/window"
    range under torch.profiler; the Trace of it.  A spin kernel starts
    the profile: the profiler may drop a profile's first device
    event."""
    from torch.profiler import ProfilerActivity, profile, record_function
    extra = {}
    try:                   # the worker threads' ranges too, where it can
        from torch._C._profiler import _ExperimentalConfig
        extra["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], **extra) as prof:
        torch.cuda._sleep(10000)
        torch.cuda.synchronize()
        with record_function(TR.WINDOW):
            body()
    tr = TR.read(prof)
    print(f"bench: trace events {TR.kinds(prof)}; device ops "
          f"{len(tr.device)}, host ranges {len(tr.ranges)}",
          file=sys.stderr)
    return tr


class Runner:
    def __init__(self, cell, seed: int, device):
        import torch
        self.torch = torch
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell.config, cell.traffic
        self.cuda = device.type == "cuda"
        self.run = Run()
        self.laps: list = []
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        """Record the seconds since the last lap under `name` (the run's
        log shows where set-up goes)."""
        t = time.perf_counter()
        self.laps.append((name, round(t - self._t, 3)))
        self._t = t

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def setup(self, mark_setup):
        raise NotImplementedError

    def window(self, seconds: float, profiled: bool):
        raise NotImplementedError

    def release(self):
        raise NotImplementedError

    def control(self):
        raise NotImplementedError

    def check(self) -> dict:
        raise NotImplementedError
