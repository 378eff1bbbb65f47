"""The port's checkpoints (`repro_torch/checkpoint/ckpt.py`), fault-
tolerant trainer (`repro_torch/train/trainer.py`), training CLI
(`repro_torch/launch/train.py`) and end-to-end example
(`repro_torch/examples/e2e_train.py`) on the CPU: the counterparts of
tests/test_system.py's checkpoint and trainer tests at the reduced
smollm-135m.  Checkpoints round-trip bit for bit (float32 and bfloat16
leaves, the optimizer state); a crash restores from the last checkpoint
and ends with exactly an uninterrupted run's parameters.
"""

import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import ckpt as CK
from repro_torch.data.synthetic import DataConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg():
    return configs.get_config("smollm-135m").reduced()


def _data_cfg(cfg, batch=4, seq=32):
    return DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      seed=7)


def _equal_trees(a: dict, b: dict):
    flat_a, flat_b = dict(CK._flatten(a)), dict(CK._flatten(b))
    assert flat_a.keys() == flat_b.keys()
    for k, x in flat_a.items():
        y = flat_b[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x.cpu(), y.cpu()), k


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state_tree(dtype):
    cfg = configs.get_config("smollm-135m").reduced()
    model = T.init_params(cfg, 0, "cpu").to(dtype)
    params = dict(model.named_parameters())
    opt = adamw.init_state(params, adamw.AdamWConfig(state_dtype="bfloat16"))
    gen = torch.Generator().manual_seed(1)
    for mom in ("m", "v"):
        for t in opt[mom].values():
            t.copy_(torch.randn(t.shape, generator=gen))
    opt["step"] += 3
    return {"params": params, "opt": opt}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_bit_exact(dtype):
    """Parameters in float32 or bfloat16 (a bf16 leaf is stored as its
    bits), the bf16 moments and the int32 step: restored bit for bit,
    over several shards; the manifest names each leaf."""
    tree = _state_tree(dtype)
    with tempfile.TemporaryDirectory() as d:
        path = CK.save(d, 3, tree, {"next_step": 3, "mesh": [16, 16]},
                       shard_size=16)
        n = len(list(CK._flatten(tree)))
        assert len(list(Path(path).glob("shard_*.npz"))) == -(-n // 16) > 2
        got, extra = CK.restore(d)
    assert extra == {"next_step": 3, "mesh": [16, 16]}
    _equal_trees(got, tree)
    assert CK.digest(got) == CK.digest(tree)
    model = T.init_params(_tiny_cfg(), 1, "cpu").to(dtype)
    model.load_state_dict(got["params"], strict=True)


def test_checkpoint_crash_mid_save_ignored():
    tree = {"params": {"w": torch.arange(6.0)}}
    with tempfile.TemporaryDirectory() as d:
        CK.save(d, 5, tree, {"next_step": 5})
        os.makedirs(os.path.join(d, "step_10.tmp"))       # crashed save
        with open(os.path.join(d, "step_10.tmp", "shard_0.npz"), "w") as f:
            f.write("partial")
        assert CK.latest_step(d) == 5
        assert not os.path.exists(os.path.join(d, "step_10.tmp"))
        got, extra = CK.restore(d)
    assert extra["next_step"] == 5
    assert torch.equal(got["params"]["w"], tree["params"]["w"])


def test_async_checkpointer_one_save_in_flight(monkeypatch):
    """save_async copies its tree to the host before the thread starts
    (the caller may change its tensors at once), and waits for the save
    in flight before it starts another: never two at a time."""
    real_save, live, peak = CK.save, [0], [0]
    lock = threading.Lock()

    def slow_save(*args, **kw):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.2)
        try:
            return real_save(*args, **kw)
        finally:
            with lock:
                live[0] -= 1

    monkeypatch.setattr(CK, "save", slow_save)
    w = torch.zeros(4)
    with tempfile.TemporaryDirectory() as d:
        ck = CK.AsyncCheckpointer(d)
        for step in (1, 2, 3):
            w.fill_(step)
            ck.save_async(step, {"w": w}, {"next_step": step})
            w.fill_(-1)                 # the snapshot is already taken
        ck.wait()
        assert peak[0] == 1
        assert CK.latest_step(d) == 3
        for step in (1, 2, 3):
            got, _ = CK.restore(d, step)
            assert torch.equal(got["w"], torch.full((4,), float(step)))


# ---------------------------------------------------------------------------
# training loop + fault tolerance
# ---------------------------------------------------------------------------

def test_loss_decreases():
    cfg = _tiny_cfg()
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg, adamw.AdamWConfig(lr=3e-3, warmup_steps=5),
                     TrainerConfig(steps=30, ckpt_every=50, ckpt_dir=d,
                                   log_every=100),
                     _data_cfg(cfg), device="cpu")
        st = tr.run()
    first = np.mean(st.losses[:5])
    last = np.mean(st.losses[-5:])
    assert len(st.losses) == 30
    assert last < first - 0.1, (first, last)


def test_crash_restart_resumes_exactly():
    """A failure injected at step 12 restores the step-10 checkpoint and
    ends with exactly the parameters and optimizer state of an
    uninterrupted run."""
    cfg = _tiny_cfg()
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2)

    def run(fault, d):
        crashed = {"done": False}

        def hook(step):
            if fault and step == 12 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("injected node failure")

        tr = Trainer(cfg, ocfg,
                     TrainerConfig(steps=15, ckpt_every=5, ckpt_dir=d,
                                   log_every=100),
                     _data_cfg(cfg), fault_hook=hook, device="cpu")
        st = tr.run()
        tree, extra = CK.restore(d)
        return st, tr, tree, extra

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        st_f, tr_f, tree_f, extra_f = run(True, d1)
        st_n, tr_n, tree_n, extra_n = run(False, d2)
    assert st_f.restarts == 1 and st_n.restarts == 0
    assert extra_f == extra_n == {"next_step": 15}
    assert len(st_f.losses) == 15 + 2          # steps 10, 11 ran twice
    assert st_f.losses[-5:] == st_n.losses[-5:]
    _equal_trees(tree_f, tree_n)
    _equal_trees(tree_f["params"], dict(tr_f.model.named_parameters()))


def test_straggler_watchdog_fires():
    cfg = _tiny_cfg()
    events = []
    slow = {"injected": False}

    def fault(step):
        if step == 8 and not slow["injected"]:
            slow["injected"] = True
            time.sleep(1.0)            # simulated straggling host

    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg, adamw.AdamWConfig(),
                     TrainerConfig(steps=10, ckpt_every=100, ckpt_dir=d,
                                   log_every=100, straggler_factor=20.0),
                     _data_cfg(cfg), fault_hook=fault,
                     straggler_hook=lambda s, dt: events.append((s, dt)),
                     device="cpu")
        st = tr.run()
    assert len(st.straggler_events) >= 1
    assert st.straggler_events[0][0] == 8
    assert events and events[0][0] == 8


def test_trainer_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, adamw.AdamWConfig(), TrainerConfig(), _data_cfg(cfg))


# ---------------------------------------------------------------------------
# the CLI and the example, as a user runs them
# ---------------------------------------------------------------------------

def _run(argv):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *argv], env=env,
                          capture_output=True, text=True, timeout=600)


def test_train_cli_runs_and_resumes_after_a_crash():
    """`python -m repro_torch.launch.train` with a failure injected at
    step 4 and checkpoints every 2 steps ends with the parameters of a
    run without it."""
    base = ["repro_torch.launch.train", "--arch", "smollm-135m",
            "--reduced", "--steps", "6", "--batch", "4", "--seq", "32",
            "--ckpt-every", "2", "--device", "cpu", "--deterministic"]
    runs = [_run(base), _run(base + ["--crash-at", "4"])]
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
        assert "final loss" in r.stdout
    assert "restarts=0" in runs[0].stdout and "restarts=1" in runs[1].stdout
    digests = [r.stdout.split("params sha256 ")[1].split()[0] for r in runs]
    assert digests[0] == digests[1]


def test_e2e_example_runs():
    r = _run(["repro_torch.examples.e2e_train", "--steps", "6",
              "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "trained 6 steps on cpu" in r.stdout
