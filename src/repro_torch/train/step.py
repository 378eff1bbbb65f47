"""Train, serve and prefill step builders: the port of
`repro/train/step.py`.

The train step takes the model (an `nn.Module` whose parameters it
updates in place), the optimizer state and a batch of tensors on the
model's device, and returns (model, new optimizer state, metrics).  It
runs eager: JAX jits its step.  With microbatches > 1 it splits the
batch into equal parts along its first axis, accumulates their
gradients in `grad_accum_dtype`, divides by the count and reports the
mean loss as {"ce": loss, "aux": 0}, as JAX's scan does
(`make_accum_grad_fn`, which the dry run walks).  With
`param_shardings` ({name: spec}, `launch/specs.py:param_shardings`)
each microbatch's accumulated gradient is pinned to its parameter's
spec (`models/sharding.py:with_sharding_constraint`), JAX's pin: the
identity on the tensors, billed by the dry run as the gradient's
reduction into the parameter's layout.
"""

from __future__ import annotations

import torch

from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.utils.loops import steps


def make_loss_fn(cfg):
    """loss_fn(model, batch) -> (loss, metrics): `forward_train` under
    cfg."""
    def loss_fn(model, batch):
        return T.forward_train(model, batch, cfg)
    return loss_fn


def make_grad_fn(cfg):
    """grad_fn(model, batch) -> (loss, metrics, grads): the loss and its
    gradient by parameter name, each in its parameter's dtype (zeros for
    a parameter the loss does not reach, as `jax.grad` gives).  Turns
    gradients on for the model's parameters."""
    loss_fn = make_loss_fn(cfg)

    def grad_fn(model, batch):
        model.requires_grad_(True)
        names, params = zip(*model.named_parameters())
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(names, grads))
    return grad_fn


def _split(batch: dict, n: int) -> list[dict]:
    """n equal microbatches along the first axis."""
    parts = {}
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {k} of {x.shape[0]} rows does not "
                             f"split into {n} microbatches")
        parts[k] = x.reshape(n, x.shape[0] // n, *x.shape[1:])
    return [{k: x[i] for k, x in parts.items()} for i in range(n)]


def apply_grads(model, opt_state: dict, grads: dict,
                opt_cfg: adamw.AdamWConfig) -> dict:
    """One AdamW update of the model's parameters, in place, from float32
    `grads` by parameter name; returns the new optimizer state."""
    params = dict(model.named_parameters())
    new_params, new_opt = adamw.apply_updates(
        {k: p.detach() for k, p in params.items()}, grads, opt_state,
        opt_cfg)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(new_params[k])
    return new_opt


def make_accum_grad_fn(cfg, microbatches: int = 1, param_shardings=None,
                       grad_accum_dtype=torch.float32):
    """accum(model, batch) -> (loss, metrics, grads): `make_grad_fn`'s on
    the whole batch, the gradients in float32; with microbatches > 1,
    their mean over equal microbatches, accumulated in grad_accum_dtype
    from zeros (JAX's scan), with metrics {"ce": the mean loss, "aux":
    0}.  param_shardings ({name: spec}) pins the accumulator to the
    parameters' specs, leaf by leaf: each microbatch's sum (role
    "grad:<name>"), as JAX pins its carry, and the zeros and the final
    mean ("grad_layout:<name>"; JAX pins the zeros, and the mean keeps
    the carry's layout).
    The microbatch loop is a `utils/loops.py:steps` loop: the dry run's
    cost walk runs one microbatch and counts it `microbatches` times."""
    grad_fn = make_grad_fn(cfg)

    def pin(role, k, a):
        if param_shardings is None:
            return a
        return S.with_sharding_constraint(a, param_shardings[k],
                                          role=f"{role}:{k}")

    def accum(model, batch):
        if microbatches == 1:
            loss, metrics, grads = grad_fn(model, batch)
            return loss, metrics, {k: g.float() for k, g in grads.items()}
        mbs = _split(batch, microbatches)
        acc = {k: pin("grad_layout", k, torch.zeros(
            p.shape, dtype=grad_accum_dtype, device=p.device))
            for k, p in model.named_parameters()}
        ltot = None
        for i in steps(microbatches, "microbatches"):
            loss_i, _m, g = grad_fn(model, mbs[i])
            acc = {k: pin("grad", k, acc[k] + g[k].to(grad_accum_dtype))
                   for k in acc}
            ltot = loss_i if ltot is None else ltot + loss_i
        loss = ltot / microbatches
        return loss, {"ce": loss, "aux": torch.zeros_like(loss)}, \
            {k: pin("grad_layout", k, a.float() / microbatches)
             for k, a in acc.items()}

    return accum


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, microbatches: int = 1,
                    param_shardings=None, grad_accum_dtype=torch.float32):
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics {"ce", "aux", "loss"}): `make_accum_grad_fn`'s gradients,
    then `apply_grads`.  param_shardings pins the microbatch gradient
    accumulator to the parameters' specs; grad_accum_dtype=torch.bfloat16
    halves the accumulator's memory (few microbatches)."""
    accum = make_accum_grad_fn(cfg, microbatches, param_shardings,
                               grad_accum_dtype)

    def train_step(model, opt_state, batch):
        loss, metrics, grads = accum(model, batch)
        new_opt = apply_grads(model, opt_state, grads, opt_cfg)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return model, new_opt, metrics

    return train_step


def make_serve_step(cfg):
    """serve_step(model, cache, batch, pos) -> (logits, cache)."""
    def serve_step(model, cache, batch, pos):
        return T.forward_decode(model, cache, batch, pos)
    return serve_step


def make_prefill_step(cfg):
    """prefill_step(model, batch) -> last-token logits."""
    def prefill_step(model, batch):
        return T.forward_prefill(model, batch)
    return prefill_step
