"""Serving policy: admission limits, retry and backoff, circuit
breakers, and the kernel degradation ladder.

The port's copy of `repro/serving/policy.py`.  Everything here is
host-side control state with an injectable clock, so every transition
(breaker open -> half-open -> closed, backoff growth) is testable
without sleeping.  The frontend (serving/frontend.py) is the only
writer; `healthz()` reads the breaker states out.

Quarantine is a circuit breaker: an (impl, bucket, precision) triple
whose kernel keeps failing opens its breaker, the ladder routes traffic
to the next impl down (`kernels/ops.py:fallback_chain`: cuda_fused ->
cuda_batched -> blocked, cuda_pairs -> blocked; on the card the ladder
stops at the last kernel rung), and after `breaker_cooldown` the
half-open state lets one probe request try the quarantined kernel
again.  Every impl is bit-identical, so a degraded request returns
exactly the bytes the healthy path would.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.kernels import ops as K


@dataclass
class ServingPolicy:
    """Tunable knobs of the serving frontend.  Defaults are sized for
    interactive traffic on one card; tests shrink them."""

    # -- admission / backpressure --
    max_queue_depth: int = 256        # admitted, not-yet-finished requests
    max_queued_items: int = 1 << 16   # queued-work estimate: sum of rows
    max_batch_requests: int = 64      # requests coalesced per batch cycle
    coalesce_window: float = 0.0      # extra seconds to wait for arrivals

    # -- deadlines --
    default_timeout: float | None = None   # per-request, None = no deadline

    # -- retry (transient faults only) --
    max_retries: int = 3
    backoff_base: float = 0.01        # first retry delay, seconds
    backoff_cap: float = 0.5          # exponential growth ceiling
    backoff_jitter: float = 0.5       # max fractional jitter added
    retry_seed: int = 0               # seeds the jitter RNG (determinism)

    # -- quarantine breakers (kernel faults) --
    breaker_threshold: int = 1        # kernel faults to open (compile
                                      # faults are deterministic: 1)
    breaker_cooldown: float = 30.0    # seconds until a half-open probe


def backoff_delay(policy: ServingPolicy, attempt: int,
                  rng=None) -> float:
    """Capped exponential backoff for retry `attempt` (1-based), with
    deterministic jitter drawn from `rng` when given."""
    d = min(policy.backoff_cap,
            policy.backoff_base * (2 ** (attempt - 1)))
    if rng is not None and policy.backoff_jitter:
        d *= 1.0 + policy.backoff_jitter * rng.random()
    return d


class CircuitBreaker:
    """closed -> open -> half_open -> {closed, open} breaker.

    closed:    traffic flows; `threshold` consecutive failures open it.
    open:      traffic blocked for `cooldown` seconds.
    half_open: exactly one probe is allowed through; its success
               closes the breaker, its failure re-opens (and restarts
               the cooldown).
    """

    def __init__(self, threshold: int = 1, cooldown: float = 30.0,
                 clock=time.monotonic):
        self.threshold = max(1, threshold)
        self.cooldown = cooldown
        self.clock = clock
        self._failures = 0
        self._state = "closed"
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        if (self._state == "open"
                and self.clock() - self._opened_at >= self.cooldown):
            return "half_open"
        return self._state

    def allow(self) -> bool:
        s = self.state
        if s == "closed":
            return True
        if s == "open":
            return False
        # half_open: admit exactly one probe until it reports back
        if self._probing:
            return False
        self._probing = True
        return True

    def record_success(self) -> None:
        self._failures = 0
        self._state = "closed"
        self._probing = False

    def release_probe(self) -> None:
        """Return an un-adjudicated half-open probe slot (the probe
        hit a TRANSIENT fault, which says nothing about whether the
        quarantined kernel healed)."""
        self._probing = False

    def record_failure(self) -> None:
        self._failures += 1
        if self.state != "closed" or self._failures >= self.threshold:
            self._state = "open"
            self._opened_at = self.clock()
            self._probing = False


class KernelLadder:
    """Quarantine book-keeping: one breaker per (impl, bucket,
    precision) triple, walked down the registry fallback ladder.

    `select` returns the first impl in `fallback_chain(requested,
    device)` whose breaker admits traffic (None when the whole ladder
    is quarantined); `record_failure` on a kernel-classified fault
    opens that triple's breaker so the next select degrades past it.
    `device` is the service's: on "cuda" the ladder never reaches
    "blocked" unless it was requested.
    """

    def __init__(self, policy: ServingPolicy, clock=time.monotonic,
                 device=None):
        self.policy = policy
        self.clock = clock
        self.device = device
        self._breakers: dict[tuple, CircuitBreaker] = {}

    def _breaker(self, impl: str, bucket: int, m: int) -> CircuitBreaker:
        key = (impl, bucket, m)
        br = self._breakers.get(key)
        if br is None:
            br = CircuitBreaker(self.policy.breaker_threshold,
                                self.policy.breaker_cooldown,
                                clock=self.clock)
            self._breakers[key] = br
        return br

    def select(self, requested: str, bucket: int, m: int) -> str | None:
        for impl in K.fallback_chain(requested, self.device):
            if self._breaker(impl, bucket, m).allow():
                return impl
        return None

    def record_success(self, impl: str, bucket: int, m: int) -> None:
        self._breaker(impl, bucket, m).record_success()

    def record_failure(self, impl: str, bucket: int, m: int) -> None:
        self._breaker(impl, bucket, m).record_failure()

    def release_probe(self, impl: str, bucket: int, m: int) -> None:
        self._breaker(impl, bucket, m).release_probe()

    def quarantined(self) -> list[str]:
        """Sorted "impl/b<bucket>/m<m>" keys whose breaker is not
        closed (the healthz quarantine set)."""
        return sorted(f"{i}/b{b}/m{m}"
                      for (i, b, m), br in self._breakers.items()
                      if br.state != "closed")

    def states(self) -> dict[str, str]:
        """Every known breaker's current state, keyed like
        `quarantined()` (closed breakers included)."""
        return {f"{i}/b{b}/m{m}": br.state
                for (i, b, m), br in sorted(self._breakers.items())}
