"""Fault-tolerant checkpointing: the port of `repro/checkpoint/ckpt.py`.
Sharded npz and a manifest, an atomic rename, an async save thread, and
a restore onto any device.

Layout:
  <dir>/step_<k>.tmp/...   (written)
  <dir>/step_<k>/          (atomic rename on completion)
      manifest.json        leaf names, shapes, dtypes, step, extra
      shard_<i>.npz        flat leaves, at most shard_size a shard

A tree is a nested dict whose leaves are tensors (or numpy arrays, or
Python numbers): the trainer saves {"params": {name: tensor}, "opt":
{"m": {...}, "v": {...}, "step": tensor}}.  Where JAX writes its
serialised treedef, the manifest lists each leaf's key path (`names`),
and restore rebuilds the nested dicts from them.  numpy has no
bfloat16, so a bfloat16 leaf is stored as its bits (int16) under its
dtype name, and restore views the bits back: bit-exact.

Restore never assumes the saving device: leaves are read on the host
and moved to `device` (the CPU when None).  Elastic restore
(`shardings=`, a tree of specs beside a `launch/mesh.py:DeviceMesh` and
a shard `rank`) gives each leaf as that shard's slice of the saved
array, JAX's `restore(shardings=)` onto a new layout: the saving layout
need not be the restoring one.  Writes are all-or-nothing:
a crash mid-save leaves only a .tmp directory, which `latest_step`
ignores and removes; the previous complete step wins.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree, path=()):
    """(key path, leaf) pairs in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, tree


def _array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array and the dtype name it is restored to."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy(), name
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _leaf(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device) if device is not None else t


def _to_host(tree):
    """The tree with each tensor leaf copied to the host: the caller may
    go on changing its tensors."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def digest(tree: Any) -> str:
    """sha256 over the tree's key paths, dtypes and leaf bytes: equal
    digests, bit-equal trees."""
    h = hashlib.sha256()
    for path, leaf in _flatten(tree):
        a, dt = _array(leaf)
        h.update(repr((path, dt, a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         shard_size: int = 64) -> str:
    """Synchronous save; returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = [(path, *_array(leaf)) for path, leaf in _flatten(tree)]
    host = [a for _, a, _ in flat]
    for i in range(0, len(host), shard_size):
        np.savez(os.path.join(tmp, f"shard_{i // shard_size}.npz"),
                 **{f"a{j}": a for j, a in enumerate(host[i:i + shard_size])})
    manifest = {
        "step": step,
        "n_leaves": len(host),
        "shard_size": shard_size,
        "names": [list(path) for path, _, _ in flat],
        "shapes": [list(a.shape) for a in host],
        "dtypes": [dt for _, _, dt in flat],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                   # atomic publish
    return final


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None) -> None:
        self.wait()
        host = _to_host(tree)                 # snapshot on host

        def _worker():
            save(self.ckpt_dir, step, host, extra)

        self._thread = threading.Thread(target=_worker, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(ckpt_dir, name,
                                                "manifest.json")):
            steps.append(int(name.split("_")[1]))
        elif name.endswith(".tmp"):          # crashed mid-save: discard
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    return max(steps) if steps else None


def _shard(a: np.ndarray, spec, mesh, rank: int) -> np.ndarray:
    """Shard `rank`'s slice of `a` under `spec` on `mesh`."""
    from repro_torch.models.sharding import shard_index
    index = []
    for n, (i, k) in zip(a.shape, shard_index(spec, mesh, rank)):
        if n % k:
            raise ValueError(f"dim {n} does not split {k} ways ({spec})")
        index.append(slice(i * (n // k), (i + 1) * (n // k)))
    return a[tuple(index)]


def _spec_at(shardings, names):
    node = shardings
    for k in names:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


def restore(ckpt_dir: str, step: Optional[int] = None, device=None,
            shardings=None, mesh=None, rank: int = 0) -> tuple[dict, dict]:
    """Load (tree, extra), the leaves as tensors on `device` (the CPU
    when None): the restore onto another device than the saving one.
    With `shardings` (a tree of specs shaped like the saved tree; a leaf
    it lacks, or None, comes back whole) on `mesh`, each leaf is shard
    `rank`'s slice of the saved array, on `device` or else the mesh's
    device of that shard: the elastic restore."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    n, ss = manifest["n_leaves"], manifest["shard_size"]
    host = []
    for i in range(0, n, ss):
        with np.load(os.path.join(path, f"shard_{i // ss}.npz")) as z:
            host.extend(z[f"a{j}"] for j in range(len(z.files)))
    if shardings is not None and device is None:
        device = mesh.devices[rank]
    tree: dict = {}
    for names, a, dt in zip(manifest["names"], host, manifest["dtypes"]):
        spec = None if shardings is None else _spec_at(shardings, names)
        if spec:
            a = _shard(a, spec, mesh, rank)
        node = tree
        for k in names[:-1]:
            node = node.setdefault(k, {})
        node[names[-1]] = _leaf(a, dt, device)
    return tree, manifest["extra"]
