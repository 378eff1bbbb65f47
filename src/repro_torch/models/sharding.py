"""Sharding-constraint helpers usable from inside model code: the port of
`repro/models/sharding.py`.

Model code calls ``constrain(x, "data", None, "model", role="mlp_in")``
at JAX's points.  The port runs a tensor whole on its device, so
`constrain` is the identity on the tensor.  With no mesh active it does
nothing else.  With a mesh active (`use_mesh`, a
`launch/mesh.py:DeviceMesh`) and an observer installed (`observe`: the
dry run's collective bill, `launch/dryrun.py:_Bill`), it reports the
tensor, its spec and its role there: the role says what the tensor is
(`ROLES`), so that the bill of the layout change JAX's
`with_sharding_constraint` makes at that point depends on nothing else
of the calling code.

A spec is a tuple with one entry per dimension: None, an axis name, or
a tuple of names, the entries of JAX's `PartitionSpec`.  Axes that do
not divide the corresponding mesh-axis size are dropped silently (e.g.
kv_heads=8 on a model axis of 16 stays replicated, matching
Megatron-style GQA KV replication).  "data" expands to ("pod", "data")
on a multi-pod mesh so the batch is sharded across pods as well.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Optional

_MESH = None
_OBSERVER: Optional[Callable] = None

# the roles of the model's `constrain` points (the file that reports
# each); `with_sharding_constraint`'s pins of the gradient accumulator
# (`train/step.py`) report "grad_layout:<name>" and "grad:<name>"
ROLES = (
    "embed",                                   # transformer._embed_inputs
    "residual",                                # transformer._backbone
    "q", "k", "v",                             # layers._project_qkv
    "mlp_in", "mlp_gate", "mlp_out",           # layers.mlp
    "moe_dispatch", "moe_out",                 # moe.moe_apply
    "timemix_out", "channelmix_hidden",        # rwkv
    "mamba_inner",                             # mamba.mamba_apply
)


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """The mesh (or None) for model code run inside the block."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


@contextlib.contextmanager
def observe(fn: Callable):
    """Inside the block, `constrain` and `with_sharding_constraint` under
    a mesh call fn(x, spec, role)."""
    global _OBSERVER
    prev = _OBSERVER
    _OBSERVER = fn
    try:
        yield
    finally:
        _OBSERVER = prev


def _expand(axis):
    """'data' -> ('pod', 'data') when the mesh has a pod axis."""
    if _MESH is None:
        return axis
    if axis == "data" and "pod" in _MESH.axis_names:
        return ("pod", "data")
    return axis


def _axis_size(axis) -> int:
    names = axis if isinstance(axis, tuple) else (axis,)
    return math.prod(_MESH.sizes[a] for a in names)


def spec_for(x_shape, *axes) -> tuple:
    """The spec of a tensor of x_shape, with non-dividing axes dropped."""
    entries = []
    for dim, axis in enumerate(axes):
        if axis is None or _MESH is None:
            entries.append(None)
            continue
        axis = _expand(axis)
        names = axis if isinstance(axis, tuple) else (axis,)
        if any(a not in _MESH.axis_names for a in names):
            entries.append(None)
            continue
        size = _axis_size(axis)
        if x_shape[dim] % size == 0 and x_shape[dim] >= size:
            entries.append(axis)
        else:
            entries.append(None)
    return tuple(entries)


def constrain(x, *axes, role: str):
    """x itself; under a mesh with an observer, x's spec and role (one
    of `ROLES`) go to the observer first."""
    if _MESH is None or _OBSERVER is None:
        return x
    if role not in ROLES:
        raise ValueError(f"constrain: unknown role {role!r}")
    if len(axes) < x.ndim:
        axes = axes + (None,) * (x.ndim - len(axes))
    _OBSERVER(x, spec_for(x.shape, *axes), role)
    return x


def with_sharding_constraint(x, spec, role: str):
    """x itself, pinned to `spec` as given (JAX's
    `jax.lax.with_sharding_constraint` with a NamedSharding): under a
    mesh with an observer, the spec and role go to the observer
    first."""
    if _MESH is not None and _OBSERVER is not None:
        _OBSERVER(x, tuple(spec), role)
    return x


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: JAX's `NamedSharding`."""
    mesh: object
    spec: tuple


def named_sharding(*spec_entries) -> Optional[NamedSharding]:
    if _MESH is None:
        return None
    return NamedSharding(_MESH, tuple(spec_entries))


def spec_size(entry, mesh) -> int:
    """The shard count of one spec entry on `mesh`."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.sizes[a] for a in names)


def shard_shape(shape, spec, mesh) -> tuple:
    """One shard's shape of an array of `shape` laid out by `spec`."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for n, e in zip(shape, spec):
        k = spec_size(e, mesh)
        if n % k:
            raise ValueError(f"dim {n} does not split {k} ways ({spec})")
        out.append(n // k)
    return tuple(out)


def shard_index(spec, mesh, rank: int) -> tuple:
    """The shard of each dimension that mesh shard `rank` (row-major over
    the axes) holds under `spec`: a tuple of (index, count)."""
    coords = {}
    rest = rank
    for name, size in reversed(list(mesh.sizes.items())):
        coords[name] = rest % size
        rest //= size
    out = []
    for e in spec:
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        idx = 0
        for a in names:
            idx = idx * mesh.sizes[a] + coords[a]
        out.append((idx, spec_size(e, mesh)))
    return tuple(out)
