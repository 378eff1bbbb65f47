"""AdamW with a configurable state dtype: the port of
`repro/optim/adamw.py`, plain functions on tensors.

Parameters, gradients and the moments are dicts keyed by the model's
parameter names (`dict(model.named_parameters())`).  The update is
JAX's, step for step: one global-norm clip over every gradient in
float32 (norm + 1e-12 under the root), a linear warmup of the learning
rate, bias correction at the incremented step, weight decay decoupled
from the moments and applied to the parameter in float32, the new
parameter cast back to its own dtype, and m, v kept in `state_dtype`
("float32", or "bfloat16" to halve optimizer memory).  It is not
`torch.optim.AdamW`, whose clip, schedule and cast order differ.
`zero1_spec` is JAX's ZeRO-1 layout: the optimizer state sharded over
the data axis on top of the parameter's spec (`launch/specs.py` runs it
for every leaf).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"     # "bfloat16" halves optimizer memory
    warmup_steps: int = 100


def init_state(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments in cfg.state_dtype beside each parameter, and the
    step, an int32 scalar on the parameters' device."""
    dt = getattr(torch, cfg.state_dtype)
    dev = next(iter(params.values())).device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step`: linear warmup to cfg.lr."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict,
                  cfg: AdamWConfig) -> tuple[dict, dict]:
    """Returns (new_params, new_state): global-norm clip, then AdamW, on
    new tensors (the inputs are left as they are)."""
    step = state["step"] + 1
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads.values())
                       + 1e-12)
    scale = torch.clamp(cfg.grad_clip / gnorm, max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    sdt = getattr(torch, cfg.state_dtype)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * scale
        m32 = b1 * state["m"][k].float() + (1 - b1) * g
        v32 = b2 * state["v"][k].float() + (1 - b2) * g * g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m32.to(sdt), v32.to(sdt)
    return new_p, {"m": new_m, "v": new_v, "step": step}


def zero1_spec(param_spec: tuple, shape, mesh) -> tuple:
    """ZeRO-1: shard optimizer state over "data" on the first dimension
    that is unsharded and divisible by the data-axis size."""
    if mesh is None or "data" not in mesh.axis_names:
        return tuple(param_spec)
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))

    def uses_data(e):
        return e == "data" or (isinstance(e, tuple) and "data" in e)

    if any(uses_data(e) for e in entries):
        return tuple(param_spec)             # FSDP already shards on data
    dsize = mesh.sizes["data"]
    for i, (e, n) in enumerate(zip(entries, shape)):
        if e is None and n % dsize == 0 and n >= dsize:
            entries[i] = "data"
            break
    return tuple(entries)
