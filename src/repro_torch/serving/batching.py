"""Request batching for the port's services: bucket planning, padding
and runtime counters (the port of `Batcher`, `pad_ints` and
`ServiceMetrics` from `repro/serving/batching.py`).

PyTorch runs eagerly, so there are no compiled buckets to cache; a
bucket is only the batch size a request chunk is padded to.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class Batcher:
    """Plans how a request of size n maps onto bucket sizes.

    Oversized requests are split into largest-bucket chunks; the final
    partial chunk gets the smallest bucket that fits it.
    """

    def __init__(self, buckets=(64, 256, 1024)):
        if not buckets:
            raise ValueError("need at least one batch bucket")
        self.buckets = tuple(sorted(buckets))

    def bucket_for(self, n: int) -> int:
        return next((b for b in self.buckets if b >= n), self.buckets[-1])

    def plan(self, n: int) -> list[tuple[int, int, int]]:
        """[(lo, hi, bucket)] chunks covering range(n); an empty request
        plans no chunks."""
        if n <= 0:
            return []
        big = self.buckets[-1]
        out, i = [], 0
        while n - i > big:
            out.append((i, i + big, big))
            i += big
        out.append((i, n, self.bucket_for(n - i)))
        return out


def pad_ints(xs, bucket: int, fill: int) -> list:
    """Pad a request column to the bucket size with a benign fill."""
    return list(xs) + [fill] * (bucket - len(xs))


class ServiceMetrics:
    """Runtime counters of a service: requests and items per op, true
    and padded rows, and per-(op, bucket) execution wall time.  The
    `stats()` dictionary has the keys of the JAX package's
    ServiceMetrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._requests: dict[str, int] = {}
        self._items: dict[str, int] = {}
        self._rows_true = 0
        self._rows_padded = 0
        self._seconds: dict[str, list] = {}

    def record_request(self, op: str, n_items: int) -> None:
        with self._lock:
            self._requests[op] = self._requests.get(op, 0) + 1
            self._items[op] = self._items.get(op, 0) + n_items

    def record_rows(self, bucket: int, true_rows: int) -> None:
        with self._lock:
            self._rows_true += true_rows
            self._rows_padded += bucket

    @contextmanager
    def chunk_timer(self, op: str, bucket: int):
        """Times one padded-bucket execution (host clock; the body must
        wait for the device)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                entry = self._seconds.setdefault(f"{op}/b{bucket}", [0, 0.0])
                entry[0] += 1
                entry[1] += dt

    def pad_waste(self) -> float:
        """(padded - true) / padded rows over the service lifetime."""
        with self._lock:
            padded, true = self._rows_padded, self._rows_true
        return (padded - true) / padded if padded else 0.0

    def stats(self) -> dict:
        waste = self.pad_waste()
        with self._lock:
            return {
                "requests": dict(self._requests),
                "items": dict(self._items),
                "rows_true": self._rows_true,
                "rows_padded": self._rows_padded,
                "pad_waste": waste,
                "bucket_seconds": {k: {"count": c, "sum": s}
                                   for k, (c, s) in self._seconds.items()},
            }
