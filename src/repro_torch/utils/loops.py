"""Loops that a cost walk may run once.

`steps(n, name)` is `range(n)`.  A cost walk that collapses loops
(`utils/op_costs.py:walking(collapse=True)`) installs itself here with
`collapsing`; inside it `steps` yields the first index only and the walk
counts that iteration's ops (and their backward) n times.  The loop's
results then stand for all n iterations in shape only, so a caller whose
later code depends on the other iterations' values must not use it; and
a loop whose first iteration does other work than the rest (a carry
that starts from a tensor with no gradient) is counted as n first ones.

This module imports nothing, so model and training code mark their loops
(the Mamba scan, the microbatch loop) without depending on the walk.
"""

from __future__ import annotations

import contextlib
from typing import Callable

_COLLAPSERS: list = []      # installed by the running walks, innermost last


def steps(n: int, name: str):
    """range(n), or what the innermost collapsing walk makes of it."""
    if not _COLLAPSERS or n <= 1:
        return range(n)
    return _COLLAPSERS[-1](n, name)


@contextlib.contextmanager
def collapsing(fn: Callable):
    """Inside the block, `steps(n, name)` returns fn(n, name)."""
    _COLLAPSERS.append(fn)
    try:
        yield
    finally:
        _COLLAPSERS.pop()
