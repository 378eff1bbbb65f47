"""The port's examples (`repro_torch/examples/`) run on the CPU: each
`main(["--device", "cpu", ...])` returns (each asserts its answers
against Python ints), one runs as `python -m` from a fresh interpreter,
and `--device cuda` without a card stops with a usage error."""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are
    small, and the test workers share the host's cores (at the default
    of one thread per core, torch spends three times the CPU time on
    these tests for a third less wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,args,expect", [
    ("quickstart", [], "shinv_15(27183) = 36787698193"),
    ("modexp_quickstart", [], "hits=1 misses=1"),
    ("bigint_service", [], "over 2 shards"),
    ("serving_frontend", [], "24 concurrent requests served exactly"),
    ("serving_frontend", ["--chaos-smoke"], "CHAOS SMOKE PASS"),
    ("long_context_rwkv", [], "position 524287"),
])
def test_example_runs_on_the_cpu(capsys, name, args, expect):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    mod.main(["--device", "cpu", *args])
    assert expect in capsys.readouterr().out


def test_example_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.examples.quickstart", "--device", "cpu"],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "4096-bit division exact on cpu" in r.stdout


def test_example_refuses_cuda_without_a_card(capsys):
    """--device cuda without a card stops with a usage error, not a run
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.examples import quickstart
    with pytest.raises(SystemExit) as exc:
        quickstart.main(["--device", "cuda"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
