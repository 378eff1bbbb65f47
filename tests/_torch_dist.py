"""Run a script as the ranks of a gloo process group on the CPU, one
process each (the port's `train/comm.py` on the CPU): the helper of
tests/test_torch_{ddp,pipeline,lm_dryrun}.py.

Each rank runs `python -c SCRIPT rank world port out_dir *args` with the
port on its path and one torch thread; the script joins the group with
`comm.init_group(rank, world, port, "cpu")` and writes what it finds to
out_dir/rank<r>.npz, which `run_ranks` returns.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "src"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(script: str, world: int, out_dir, *args,
              timeout: int = 300) -> list[dict]:
    """The ranks' npz files; every rank is killed, and the call raises,
    once `timeout` seconds have passed since the ranks started (a
    deadlock fails fast)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    port = free_port()
    deadline = time.monotonic() + timeout
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(port),
         str(out_dir), *map(str, args)], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    errs = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(f"rank {r}: rc {p.returncode}\n{out[-2000:]}\n"
                        f"{err[-3000:]}")
    assert not errs, "\n".join(errs)
    return [dict(np.load(Path(out_dir) / f"rank{r}.npz"))
            for r in range(world)]
