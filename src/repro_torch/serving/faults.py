"""Deterministic fault injection for the serving tier.

The port's copy of `repro/serving/faults.py`.  Real kernel-path
failures (a refused launch, CUDA out of memory, a transfer hiccup) are
rare and not reproducible, so the robustness machinery (retry,
quarantine, degradation, deadline accounting) would otherwise ship
untested.  The services expose four injection sites, and a
`FaultInjector` armed with `FaultSpec`s raises typed exceptions
(serving/errors.py) at exactly the matching events.

Sites (fired by the services when an injector is installed via
`set_fault_injector`; no-ops otherwise):

  compile     the first use of an (op, bucket, impl), where the service
              builds its kernel plan (labels: op, bucket, impl)
  transfer    before a chunk is packed onto the device (op, bucket)
  execute     before a chunk runs (op, bucket, impl)
  precompute  before a Barrett-context precompute

Determinism: count-based specs (`skip` matching events, then fail
`times` of them, then heal) are exact; rate-based specs draw from one
`random.Random(seed)` owned by the injector, so a given (plan, seed,
traffic order) always injects the same faults.  The injector is
thread-safe: chunks run on the frontend's worker thread.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass

from . import errors as E

SITES = ("compile", "transfer", "execute", "precompute")

# spec.kind -> how the raised exception classifies (errors.classify)
KINDS = ("transient", "kernel", "compile", "fatal")


@dataclass(frozen=True)
class FaultSpec:
    """One injection rule.

    site:    which injection point this spec arms (see SITES)
    op/bucket/impl: label filters; None matches anything
    times:   how many MATCHING events to fail (0 = unlimited)
    skip:    let this many matching events pass before arming
    rate:    if set, fail each matching event with this probability
             (seeded draw) instead of the skip/times counter window
    kind:    policy class of the raised fault -- "transient" retries,
             "kernel"/"compile" quarantine + degrade, "fatal" aborts
    message: override the exception message
    """
    site: str
    op: str | None = None
    bucket: int | None = None
    impl: str | None = None
    times: int = 1
    skip: int = 0
    rate: float | None = None
    kind: str = "transient"
    message: str = ""

    def matches(self, site: str, labels: dict) -> bool:
        if site != self.site:
            return False
        for field in ("op", "bucket", "impl"):
            want = getattr(self, field)
            if want is not None and labels.get(field) != want:
                return False
        return True


class FaultInjector:
    """Armed set of `FaultSpec`s plus the per-spec event counters.

    `fire(site, **labels)` is the only entry point the services call;
    it raises the first due spec's typed exception or returns None.
    """

    def __init__(self, specs=(), seed: int = 0):
        self.specs = list(specs)
        for s in self.specs:
            if s.site not in SITES:
                raise ValueError(f"unknown fault site {s.site!r}; "
                                 f"expected one of {SITES}")
            if s.kind not in KINDS:
                raise ValueError(f"unknown fault kind {s.kind!r}; "
                                 f"expected one of {KINDS}")
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._seen = [0] * len(self.specs)
        self._fired = [0] * len(self.specs)
        self._by_site = {s: 0 for s in SITES}

    def reset(self) -> None:
        """Rewind every counter and the RNG to the armed state."""
        with self._lock:
            self._rng = random.Random(self.seed)
            self._seen = [0] * len(self.specs)
            self._fired = [0] * len(self.specs)
            self._by_site = {s: 0 for s in SITES}

    def fire(self, site: str, **labels) -> None:
        """Raise the first due matching spec's fault, if any."""
        with self._lock:
            for i, spec in enumerate(self.specs):
                if not spec.matches(site, labels):
                    continue
                self._seen[i] += 1
                exhausted = spec.times and self._fired[i] >= spec.times
                if exhausted:
                    continue
                if spec.rate is not None:
                    due = self._rng.random() < spec.rate
                else:
                    due = self._seen[i] > spec.skip
                if due:
                    self._fired[i] += 1
                    self._by_site[site] += 1
                    raise self._make(spec, site, labels)

    def _make(self, spec: FaultSpec, site: str, labels: dict):
        ids = {"op": labels.get("op"), "bucket": labels.get("bucket"),
               "impl": labels.get("impl")}
        msg = spec.message or (
            f"injected {spec.kind} fault at {site} ({ids})")
        if spec.kind == "fatal":
            return E.ServingError(msg)
        if spec.kind == "compile" or site == "compile":
            return E.CompileFault(msg, **ids)
        transient = spec.kind == "transient"
        if site == "transfer":
            return E.TransferFault(msg, transient=transient, **ids)
        if site == "precompute":
            return E.PrecomputeFault(msg, transient=transient, **ids)
        return E.ExecuteFault(msg, transient=transient, **ids)

    # -- introspection ----------------------------------------------------

    def fired_total(self) -> int:
        with self._lock:
            return sum(self._fired)

    def stats(self) -> dict:
        """Plain-data injection accounting (merged into frontend
        snapshots so chaos runs are self-describing)."""
        with self._lock:
            return {
                "seed": self.seed,
                "fired_total": sum(self._fired),
                "by_site": dict(self._by_site),
                "specs": [
                    {"site": s.site, "kind": s.kind, "op": s.op,
                     "bucket": s.bucket, "impl": s.impl,
                     "seen": self._seen[i], "fired": self._fired[i]}
                    for i, s in enumerate(self.specs)],
            }
