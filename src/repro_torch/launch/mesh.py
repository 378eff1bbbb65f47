"""Device meshes for the port: the counterpart of `repro/launch/mesh.py`.

A `DeviceMesh` is an ordered tuple of `torch.device`s with axis names;
the services shard each bucket's rows over its devices in that order
(`serving/batching.py:ShardedExecutable`) and replicate the rest.  The
batch is sharded flat over every axis, as the JAX package shards it
over `(data, model)`, so only the device order and the shard count
matter here; the axis names and shape describe the layout.

A mesh may name one device more than once.  Each shard then gets its
own executable, CUDA graph, memory pool and stream on that device:
the port's counterpart of XLA's forced host device count, and the way
a one-card machine runs the split, replicate and gather path that a
mesh of several cards runs.

Functions build meshes on demand; importing this module touches no
device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

# the production target of the JAX package: a pod of 16 x 16 = 256
# chips ("data" x "model"), or two such pods on a leading "pod" axis
PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


@dataclass(frozen=True)
class DeviceMesh:
    """Shards in order (`devices`, one entry per shard, repeats
    allowed), the layout's `shape` and `axis_names`."""
    devices: tuple
    shape: tuple
    axis_names: tuple

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} holds "
                             f"{math.prod(self.shape)} shards, got "
                             f"{len(self.devices)} devices")
        if len(self.shape) != len(self.axis_names):
            raise ValueError("one axis name per mesh dimension")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError("a mesh's devices are all of one type")

    @property
    def size(self) -> int:
        """The shard count."""
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The distinct devices, in order of their first shard."""
        return tuple(dict.fromkeys(self.devices))


def mesh_of(devices) -> DeviceMesh:
    """A flat mesh ("data") over `devices` (torch.device or strings), in
    order."""
    devs = tuple(torch.device(d) for d in devices)
    return DeviceMesh(devs, (len(devs),), ("data",))


def make_production_mesh(*, multi_pod: bool = False) -> tuple:
    """(shape, axis_names, shards) of the production layout: 16 x 16
    (256 shards), or 2 x 16 x 16 (512) with `multi_pod`.  No devices:
    under pure batch sharding every shard does the same work, so the
    dry run (`launch/bigint_dryrun.py`) runs one shard of it."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = MULTI_POD_AXES if multi_pod else PRODUCTION_AXES
    return shape, axes, math.prod(shape)


def make_device_mesh(n: int | None = None) -> DeviceMesh:
    """A flat mesh over the first n visible CUDA cards (all of them by
    default)."""
    have = torch.cuda.device_count()
    n = have if n is None else n
    if not 1 <= n <= have:
        raise RuntimeError(f"a mesh of {n} CUDA devices, {have} visible")
    return mesh_of([torch.device("cuda", i) for i in range(n)])


def make_host_mesh(n: int) -> DeviceMesh:
    """n shards on the CPU (tests, examples): the plain versions run
    each shard."""
    return mesh_of([torch.device("cpu")] * n)
