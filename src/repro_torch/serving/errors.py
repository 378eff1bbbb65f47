"""Exception taxonomy and failure classification of the serving tier.

The port's copy of `repro/serving/errors.py`.  Every failure the
serving stack can surface maps onto one typed exception here, and
`classify` collapses any raised exception (typed, injected by
serving/faults.py, or a raw PyTorch or CUDA error) into one of the
policy classes the frontend acts on:

  invalid    caller error (bad type, range or shape).  Never retried,
             never counted against a kernel.
  overload   typed admission rejection (`Overloaded`); nothing was
             enqueued.
  deadline   the request's deadline expired (`DeadlineExceeded`).
  transient  plausibly succeeds on retry with the same kernel (a
             transfer hiccup).  Policy: capped, jittered retry.
  kernel     an injected fault says the kernel path is broken at this
             (impl, bucket, precision): a compile fault, or an execute
             fault that is not transient.  Policy: quarantine the triple
             and degrade down the impl ladder
             (`kernels/ops.py:fallback_chain`).
  fatal      everything else, and every real failure of a kernel: a
             library that does not build or load
             (`kernels.build.BuildError`), a refused or failed launch
             (`kernels.build.LaunchError`), CUDA out of memory.  The
             frontend never degrades around a kernel that is missing or
             fails; the error reaches the caller.

The validation helpers raise index-carrying `InvalidRequest` subtypes
that also subclass the builtin the older services raised
(`OverflowError`, `TypeError`, `ValueError`).
"""

from __future__ import annotations

# Policy classes, in the order `classify` resolves them.
CLASSES = ("invalid", "overload", "deadline", "transient", "kernel",
           "fatal")


class ServingError(Exception):
    """Base of every typed serving-tier failure."""


class Overloaded(ServingError):
    """Typed admission rejection: queue depth or queued-work estimate
    exceeds policy."""

    def __init__(self, message: str = "", *, reason: str = "",
                 depth: int = 0, limit: int = 0):
        self.reason = reason
        self.depth = depth
        self.limit = limit
        super().__init__(
            message or f"overloaded ({reason}): depth {depth} >= "
                       f"limit {limit}")


class DeadlineExceeded(ServingError, TimeoutError):
    """The request's deadline expired before all its chunks ran;
    `completed`/`total` count the rows done and asked for (the request
    fails as a whole)."""

    def __init__(self, message: str = "", *, op: str = "",
                 completed: int = 0, total: int = 0):
        self.op = op
        self.completed = completed
        self.total = total
        super().__init__(
            message or f"deadline exceeded ({op}): {completed}/{total} "
                       f"items completed before expiry")


class RequestCancelled(ServingError):
    """The frontend stopped before the request ran."""


class InvalidRequest(ServingError, ValueError):
    """Caller error: malformed request (shape/type/range)."""


class OperandRangeError(InvalidRequest, OverflowError):
    """An operand is outside the service's representable range."""


class OperandTypeError(InvalidRequest, TypeError):
    """An operand is not a Python int."""


class KernelFault(ServingError):
    """Base of kernel-path failures, real or injected, with the (site,
    op, bucket, impl) the ladder and the metrics key on."""

    def __init__(self, message: str = "", *, site: str = "execute",
                 op: str | None = None, bucket: int | None = None,
                 impl: str | None = None, transient: bool = False):
        self.site = site
        self.op = op
        self.bucket = bucket
        self.impl = impl
        self.transient = transient
        super().__init__(
            message or f"{type(self).__name__} at {site} "
                       f"(op={op}, bucket={bucket}, impl={impl})")


class CompileFault(KernelFault):
    """An (op, bucket, impl) failed where its kernel plan is built.
    Always `kernel`: the same triple would fail again, so degrade."""

    def __init__(self, message: str = "", **kw):
        kw.setdefault("site", "compile")
        kw["transient"] = False
        super().__init__(message, **kw)


class ExecuteFault(KernelFault):
    """A run failed; `transient` picks retry (True) or quarantine and
    degrade (False)."""


class TransferFault(KernelFault):
    """Host-to-device packing failed.  Transient by default."""

    def __init__(self, message: str = "", **kw):
        kw.setdefault("site", "transfer")
        kw.setdefault("transient", True)
        super().__init__(message, **kw)


class PrecomputeFault(KernelFault):
    """The Barrett-context precompute failed.  Transient by default: it
    is stateless and retryable."""

    def __init__(self, message: str = "", **kw):
        kw.setdefault("site", "precompute")
        kw.setdefault("transient", True)
        super().__init__(message, **kw)


# Message markers of raw errors that carry no type to match.
_TRANSIENT_MARKERS = ("connection reset", "transfer failed")


def classify(exc: BaseException) -> str:
    """Collapse any exception into one policy class (see CLASSES)."""
    if isinstance(exc, Overloaded):
        return "overload"
    if isinstance(exc, DeadlineExceeded):
        return "deadline"
    if isinstance(exc, (InvalidRequest, TypeError, ValueError,
                        OverflowError)):
        return "invalid"
    if isinstance(exc, CompileFault):
        return "kernel"
    if isinstance(exc, KernelFault):
        return "transient" if exc.transient else "kernel"
    if isinstance(exc, ServingError):
        return "fatal"
    text = f"{type(exc).__name__}: {exc}"
    if any(m in text for m in _TRANSIENT_MARKERS):
        return "transient"
    return "fatal"


# ---------------------------------------------------------------------------
# request validation (shared by both services)
# ---------------------------------------------------------------------------

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
