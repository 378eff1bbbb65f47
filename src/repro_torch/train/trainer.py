"""Fault-tolerant training loop: the port of `repro/train/trainer.py`.

  * checkpoint/restart -- async checkpoints every `ckpt_every` steps;
    on a step failure the loop restores the latest complete checkpoint
    and continues; data skip-ahead is free because the synthetic
    pipeline is counter-based (step -> batch is a pure function).
  * restore onto any device -- a checkpoint's leaves are read on the
    host and placed on the trainer's device.
  * straggler watchdog -- per-step wall time is tracked with an EMA
    (the first two measured steps left out); a step slower than
    `straggler_factor` x EMA is recorded and fires a callback.
  * failure injection -- `fault_hook(step)` raising simulates a node
    loss at that step.

The step runs eager (JAX jits it), on `device` ("cuda" unless the
caller asks for the CPU).  A fresh start builds `init_params(cfg,
seed=0, device)`; after a run, `model` and `opt` hold the final
parameters and optimizer state.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as CK
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from .step import make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    microbatches: int = 1
    log_every: int = 10
    straggler_factor: float = 3.0
    max_restarts: int = 3


@dataclass
class TrainerState:
    restarts: int = 0
    straggler_events: list = field(default_factory=list)
    losses: list = field(default_factory=list)


class Trainer:
    def __init__(self, cfg, opt_cfg: adamw.AdamWConfig,
                 tcfg: TrainerConfig, data_cfg: DataConfig,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 straggler_hook: Optional[Callable[[int, float], None]]
                 = None, device="cuda"):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = T._device(device)
        self.stream = SyntheticStream(data_cfg)
        self.fault_hook = fault_hook
        self.straggler_hook = straggler_hook
        self.checkpointer = CK.AsyncCheckpointer(tcfg.ckpt_dir)
        self.step_fn = make_train_step(cfg, opt_cfg,
                                       microbatches=tcfg.microbatches)
        self.state = TrainerState()
        self.model = self.opt = None

    # -- init or restore ---------------------------------------------------
    def _fresh(self):
        model = T.init_params(self.cfg, 0, self.device)
        opt = adamw.init_state(dict(model.named_parameters()), self.opt_cfg)
        return model, opt, 0

    def _restore(self):
        latest = CK.latest_step(self.tcfg.ckpt_dir)
        if latest is None:
            return self._fresh()
        tree, extra = CK.restore(self.tcfg.ckpt_dir, device=self.device)
        model = T.init_params(self.cfg, 0, self.device)
        model.load_state_dict(tree["params"], strict=True)
        return model, tree["opt"], int(extra["next_step"])

    def _tree(self, model, opt) -> dict:
        return {"params": dict(model.named_parameters()), "opt": opt}

    def batch(self, step: int) -> dict:
        """The stream's batch of `step` on the trainer's device."""
        return {k: torch.from_numpy(v).to(self.device, torch.long)
                for k, v in self.stream.batch(step).items()}

    # -- main loop ---------------------------------------------------------
    def run(self) -> TrainerState:
        model, opt, start = self._restore()
        step = start
        ema = None
        measured = 0          # the first steps warm up: not in the EMA
        while step < self.tcfg.steps:
            try:
                t0 = time.time()
                if self.fault_hook:
                    self.fault_hook(step)
                model, opt, metrics = self.step_fn(model, opt,
                                                   self.batch(step))
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
                dt = time.time() - t0
                # straggler watchdog (the EMA leaves out the first steps)
                if ema is not None and dt > self.tcfg.straggler_factor * ema:
                    self.state.straggler_events.append((step, dt, ema))
                    if self.straggler_hook:
                        self.straggler_hook(step, dt)
                measured += 1
                if measured > 2:
                    ema = dt if ema is None else 0.9 * ema + 0.1 * dt
                self.state.losses.append(loss)
                if step % self.tcfg.log_every == 0:
                    print(f"step {step:5d} loss {loss:.4f} "
                          f"({dt*1e3:.0f} ms)", flush=True)
                step += 1
                if step % self.tcfg.ckpt_every == 0:
                    self.checkpointer.save_async(
                        step, self._tree(model, opt), {"next_step": step})
            except (FloatingPointError, RuntimeError, ValueError) as e:
                self.state.restarts += 1
                print(f"[trainer] step {step} failed ({e}); "
                      f"restart {self.state.restarts}", flush=True)
                if self.state.restarts > self.tcfg.max_restarts:
                    raise
                self.checkpointer.wait()
                model, opt, step = self._restore()
        self.checkpointer.wait()
        self.checkpointer.save_async(step, self._tree(model, opt),
                                     {"next_step": step})
        self.checkpointer.wait()
        self.model, self.opt = model, opt
        return self.state
