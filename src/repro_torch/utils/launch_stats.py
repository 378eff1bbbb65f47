"""The static launch profile of a port function: the counterpart of
`repro/utils/jaxpr_stats.py:trace_profile`.

JAX traces a function and counts the primitives of its jaxpr; PyTorch
runs eagerly, so the profile is taken on one real call.  The call runs
under a `kernels.build.recording` scope, which records the launches of
this package's kernels, and a `TorchDispatchMode` that counts the aten
ops the call dispatches (the torch glue around the kernels and the
wrappers' allocations: the counterpart of JAX's `xla_eqns`).  The
serving layer takes it on the warm-up call that precedes a bucket's
graph capture, so it costs no extra run.  Nothing in the port's paths
branches on data, so the counts depend on the shapes and the impl
alone.  On the CPU nothing launches: `kernel_launches` is 0 there for
every impl.
"""

from __future__ import annotations

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import build


class _AtenOps(TorchDispatchMode):
    """Counts the aten ops dispatched in this thread while it is on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def trace_profile(fn, *args, **kwargs) -> dict:
    """Run fn(*args, **kwargs) once and return its static profile:
    `kernel_launches` (this package's kernels), `glue_ops` (aten ops
    dispatched) and `total_ops` (both)."""
    ops = _AtenOps()
    with build.recording() as launches, ops:
        fn(*args, **kwargs)
    n = sum(launches.values())
    return {"kernel_launches": n, "glue_ops": ops.n,
            "total_ops": n + ops.n}
