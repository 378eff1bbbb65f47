"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` is compiled on its own, all sources in parallel,
into `_build/lib<name>-<hash>.so` beside this file (the hash covers the
sources and the flags, so an edited source is rebuilt).  The libraries
expose plain C entry points that take device pointers and the CUDA
stream as `void*`, and return a `cudaError_t` that the Python wrappers
turn into an exception: `BuildError` when a library does not build or
load, `LaunchError` when a launch is refused or fails.

Every kernel wrapper counts its launches here (`count`), so a caller can
show that a run went through the kernels: `reset_launch_counts()`
before the run, `launch_counts()` after it.  The span marks of
`csrc/marks.cu` (`kernels/marks.py`) are the one exception: they time
the counted kernels and are not counted themselves.  A thread can also
record its own launches in a `recording` scope: the serving layer's bucket
executables take their static launch profile that way, and a scope
opened for a CUDA graph capture keeps the captured launches out of the
counts (nothing ran yet), so that each replay of the graph counts them
(`count_all`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("mul", "step", "correct", "barrett", "pairs", "marks",
           "prologue")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_counts: dict[str, int] = {}
_count_lock = threading.Lock()
_local = threading.local()        # this thread's recording scopes
build_seconds: float | None = None


class BuildError(RuntimeError):
    """A kernel library did not build (nvcc missing or failing) or did
    not load."""


class LaunchError(RuntimeError):
    """A kernel launch returned a CUDA error (refused geometry, out of
    memory, a fault during the run)."""

    def __init__(self, what: str, err: int):
        self.code = err
        super().__init__(f"{what} failed with cudaError_t {err}")


def count(name: str, n: int = 1) -> None:
    """Record n launches of kernel `name` (called by its wrapper, and by
    a graph replay with its recorded launches; safe from several
    threads).  Every `recording` scope open in this thread records them
    too; under a capture scope only the scopes do, since a captured
    launch runs when its graph is replayed."""
    for rec in getattr(_local, "scopes", ()):
        rec[name] = rec.get(name, 0) + n
    if getattr(_local, "capturing", 0):
        return
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def count_all(launches: dict[str, int]) -> None:
    """Count a recorded {kernel: launches} dict once (a graph replay)."""
    for name, n in launches.items():
        count(name, n)


@contextmanager
def recording(capture: bool = False):
    """Record the launches this thread's wrappers make inside the scope
    as a {kernel: launches} dict (yielded, filled as they launch).
    Scopes nest, and another thread's launches never enter them.  With
    `capture` (a CUDA graph capture, where nothing launches yet) the
    launches go to the open scopes only, not to `launch_counts()`."""
    rec: dict[str, int] = {}
    scopes = _local.__dict__.setdefault("scopes", [])
    scopes.append(rec)
    _local.capturing = getattr(_local, "capturing", 0) + int(capture)
    try:
        yield rec
    finally:
        scopes.remove(rec)
        _local.capturing -= int(capture)


def launch_counts() -> dict[str, int]:
    with _count_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _count_lock:
        _counts.clear()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    cand = Path(home) / "bin" / "nvcc" if home else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise BuildError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes/restype of every C entry point (pointers and the stream
    as c_void_p, so ctypes does not cut them to 32 bits)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "mul_batch_launch": [P, P, P, P, I, I, I, I, P, P],
        "mul_batch_scratch_bytes": [I],
        "mul_batch_smem_bytes": [I, I, I],
        "powdiff_launch": [P, P, P, P, P, P, P, P, I, I, I, I, I, P, P],
        "update_launch": [P, P, P, P, P, P, P, P, I, I, I, I, I, P, P],
        "step_scratch_bytes": [I],
        "step_smem_bytes": [I],
        "step_lane_bytes": [I],
        "step_pack_threads": [],
        "correct_launch": [P, P, P, P, P, P, P, I, I, P, P],
        "correct_scratch_bytes": [I],
        "correct_smem_bytes": [I],
        "barrett_launch": [P, P, P, P, P, I, I, I, I, I, I, I, P, P],
        "barrett_scratch_bytes": [I],
        "barrett_smem_bytes": [I, I, I],
        "mul_pairs_launch": [P, P, P, P, I, I, I, I, I, I, I, P],
        "mul_pairs_tile": [],
        "span_mark_launch": [P, I, P],
        "span_capture_tail": [P, P],
        "prologue_launch": [P, P, P, P, P, P, P, P, P, I, I, I, P],
    }
    for fn, args in sigs.items():
        if hasattr(lib, fn):
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = ctypes.c_size_t if fn.endswith("_bytes") else I


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (where not built yet) and load every kernel library.
    Raises with nvcc's output when a build fails."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            so = BUILD_DIR / f"lib{name}-{_digest(name)}.so"
            if not so.exists():
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, so)
        logs = {}
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                for _, (p, _t, _s) in procs.items():
                    p.wait()
                raise BuildError(f"nvcc failed for {name}.cu:\n{out}")
            os.replace(tmp, so)
        if logs:                     # keep the log of the last real build
            (BUILD_DIR / "ptxas.log").write_text(
                "".join(f"== {n}.cu\n{o}" for n, o in logs.items()))
        for name in SOURCES:
            so = BUILD_DIR / f"lib{name}-{_digest(name)}.so"
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as exc:
                raise BuildError(f"cannot load {so}: {exc}") from exc
            _declare(lib)
            _libs[name] = lib
        build_seconds = time.perf_counter() - t0
        return _libs


def lib(name: str) -> ctypes.CDLL:
    return build_all()[name]


def check(err: int, what: str) -> None:
    """Raise LaunchError when a C entry point returned a CUDA error."""
    if err != 0:
        raise LaunchError(what, err)


# Shared memory a block may use on Hopper.  The product, step,
# finalization and Barrett kernels stage their operands there as 16-bit
# limbs (csrc/digitmma.cuh); the pair kernel one fixed-size v tile and u
# window in the same layouts.
SMEM_BYTES = 227 * 1024


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@contextmanager
def on_device(t: torch.Tensor):
    """Make t's card the current device for a launch and yield the
    current stream of that card (as `stream_ptr`).  The C entry points
    key their shared-memory attribute and occupancy cache by
    `cudaGetDevice` and launch on the stream they are given, so every
    launch runs inside this scope: with tensors on another card than
    the current one, a launch would otherwise go out with a stream of
    another device."""
    with torch.cuda.device(t.device):
        yield stream_ptr(t)


def check_limbs(name: str, t: torch.Tensor, shape=None) -> None:
    """Raise unless t is a contiguous int32 CUDA tensor (of `shape`)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: kernel needs a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous int32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
