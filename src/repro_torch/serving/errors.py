"""Request validation errors of the serving tier.

The port's copy of the parts of `repro/serving/errors.py` the division
service uses.  The typed errors also subclass the builtin the callers
of the older services catch (`ValueError`, `OverflowError`,
`TypeError`).
"""

from __future__ import annotations


class ServingError(Exception):
    """Base of every typed serving-tier failure."""


class InvalidRequest(ServingError, ValueError):
    """Caller error: malformed request (shape/type/range)."""


class OperandRangeError(InvalidRequest, OverflowError):
    """An operand is outside the service's representable range."""


class OperandTypeError(InvalidRequest, TypeError):
    """An operand is not a Python int."""


def check_lengths(columns, names=None) -> int:
    """All request columns must be equal-length; returns that length."""
    n = len(columns[0])
    for i, col in enumerate(columns[1:], start=1):
        if len(col) != n:
            a = names[0] if names else "column 0"
            b = names[i] if names else f"column {i}"
            raise InvalidRequest(
                f"mismatched request columns: len({a}) = {n}, "
                f"len({b}) = {len(col)}")
    return n


def check_operands(name: str, xs, limit: int, what: str) -> None:
    """Every x in xs must be a Python int in [0, limit); the error names
    the offending index."""
    for i, x in enumerate(xs):
        if isinstance(x, bool) or not isinstance(x, int):
            raise OperandTypeError(
                f"{name}[{i}]: expected int, got {type(x).__name__}")
        if not 0 <= x < limit:
            raise OperandRangeError(
                f"{name}[{i}] out of range: expected 0 <= {name} < "
                f"{what}, got {x if abs(x) < 1 << 80 else hex(x)}")
