"""Device marks (`csrc/marks.cu:span_mark_kernel`): the ring a captured
graph's span marks stamp, and the launch that stamps it.

A `Ring` is `depth` rows of marks on one card, each mark a stamp (clock
ns, mark, row), with the header the kernel reads (the stamps' address,
marks a row, depth, rows started).  The header exists from the start,
so a graph can capture marks into the ring before `allocate` gives it
its stamps; a replay's first mark takes the next row on the card.
`tail` tells whether anything was captured since the last mark.
`read` gives the stamps on the host with the card's clock moved onto
the host's realtime clock, the one `torch.profiler`'s events carry.

A mark is not one of the program's counted launches (`build.count`):
it times them.  `obs/telemetry.py:GraphMarks` holds a ring and calls
`mark`, `tail` and `read`; nothing here knows of spans.
"""

from __future__ import annotations

import ctypes
import time

import torch

from . import build


class Ring:
    def __init__(self, device, depth: int, width: int = 0):
        self.device = torch.device(device)
        self.depth = depth
        self.header = torch.zeros(4, dtype=torch.int64, device=self.device)
        self.stamps = None
        if width:
            self.allocate(width)

    def allocate(self, width: int) -> None:
        """Give the ring `width` marks a row, rows counted from 0."""
        self.stamps = torch.full((self.depth, width, 3), -1,
                                 dtype=torch.int64, device=self.device)
        self.header.copy_(torch.tensor(
            [self.stamps.data_ptr(), width, self.depth, 0]))

    def mark(self, j: int) -> None:
        """Enqueue mark j on the current stream (mark 0 starts a row)."""
        with build.on_device(self.header) as stream:
            build.check(build.lib("marks").span_mark_launch(
                self.header.data_ptr(), j, stream), "span mark kernel")

    def tail(self) -> int:
        """The one node that the next node captured on the current
        stream will follow (0: not capturing, or none or several): equal
        tails mean nothing was captured between them."""
        node = ctypes.c_ulonglong(0)
        with build.on_device(self.header) as stream:
            build.check(build.lib("marks").span_capture_tail(
                stream, ctypes.addressof(node)), "capture info")
        return node.value

    def read(self) -> torch.Tensor:
        """The stamps (depth, width, 3) on the host once the card has
        run what was enqueued, clocks on the host's realtime clock."""
        torch.cuda.synchronize(self.device)
        stamps = self.stamps.cpu()
        stamps[..., 0] -= clock_offset(self.device)
        return stamps


def clock_offset(device, tries: int = 16) -> int:
    """The card's clock minus the host's realtime clock (ns), from the
    tightest of `tries` marks each enqueued and waited for alone."""
    ring = Ring(device, tries, width=1)
    waits = []
    for _ in range(tries):
        torch.cuda.synchronize(ring.device)
        t0 = time.time_ns()
        ring.mark(0)
        torch.cuda.synchronize(ring.device)
        t1 = time.time_ns()
        waits.append((t1 - t0, (t0 + t1) // 2))
    stamps = ring.stamps[:, 0, 0].tolist()
    k = min(range(tries), key=lambda i: waits[i][0])
    return stamps[k] - waits[k][1]
