"""Top-k Mixture-of-Experts with capacity-based dispatch: the port of
`repro/models/moe.py` (phi-3.5-MoE 16e top-2, Arctic 128e top-2 + dense
residual).

Capacity: C = max(ceil(top_k * T / E * capacity_factor), 4).  A (token,
slot)'s place in its expert is a cumulative count over the flattened
(T*k, E) one-hot in token-major order; slots past C are dropped to row
E*C of the dispatch buffer (standard GShard semantics).  Gates are
renormalised over the top k; the router runs in float32; the aux term
is the Switch load-balancing loss.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import activation, dense_init, param
from .sharding import constrain


class MoE(nn.Module):
    """router (D, E) in float32; the experts' wi, wg (swiglu only) and
    wo stacked on a leading E axis, (E, D, F) and (E, F, D).  `routing`
    holds the last call's `Routing` (device tensors: its dropped slots
    are `~routing.keep`)."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, f, e, dt = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, \
            cfg.param_dtype
        stack = lambda i, o: param(torch.stack(   # noqa: E731
            [dense_init(gen, i, o, dt) for _ in range(e)]))
        self.wi = stack(d, f)
        if cfg.act == "swiglu":
            self.wg = stack(d, f)
        self.wo = stack(f, d)
        self.router = param(dense_init(gen, d, e, torch.float32))
        self.routing = None

    def forward(self, x):
        return moe_apply(self, x, self.cfg)


class Routing(NamedTuple):
    probs: torch.Tensor      # (T, E) router softmax, float32
    gates: torch.Tensor      # (T, k) renormalised top-k probabilities
    experts: torch.Tensor    # (T, k) expert ids, lower id first on ties
    slot: torch.Tensor       # (T*k,) dispatch row; E*C where dropped
    keep: torch.Tensor       # (T, k) bool: the slot fits its expert
    cap: int


def top_k(probs: torch.Tensor, k: int):
    """`jax.lax.top_k`: the k largest along the last axis, ties to the
    lower index (a stable descending sort; `torch.topk` promises no tie
    order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, xt: torch.Tensor, cfg) -> Routing:
    """The dispatch of T tokens xt (T, D) onto E experts of capacity C."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = max(int(math.ceil(k * t / e * cfg.capacity_factor)), 4)
    probs = (xt.float() @ p.router).softmax(-1)
    return dispatch(probs, top_k(probs, k)[1], cap)


def dispatch(probs: torch.Tensor, experts: torch.Tensor, cap: int) -> Routing:
    """The Routing of T tokens onto `experts` (T, k): gates the router's
    probabilities (T, E) renormalised over them, each (token, slot) placed
    by its cumulative count in token-major order, dropped past cap."""
    t, k = experts.shape
    e = probs.shape[-1]
    gates = probs.gather(-1, experts)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_oh = F.one_hot(experts, e).reshape(t * k, e)
    pos = ((flat_oh.cumsum(0) * flat_oh).sum(-1) - 1).reshape(t, k)
    keep = pos < cap
    slot = torch.where(keep, experts * cap + pos, e * cap).reshape(-1)
    return Routing(probs, gates, experts, slot, keep, cap)


def expert_mlp(p, xe: torch.Tensor, cfg) -> torch.Tensor:
    """Every expert's FFN on its (C, D) rows, batched over E."""
    dt = xe.dtype
    g = torch.bmm(xe, p.wg.to(dt)) if cfg.act == "swiglu" else None
    h = activation(torch.bmm(xe, p.wi.to(dt)), g, cfg.act)
    return torch.bmm(h, p.wo.to(dt))


def moe_apply(p, x, cfg):
    """x: (B, S, D) -> (B, S, D), plus the aux load-balance loss."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.moe_top_k
    xt = x.reshape(t, d)
    r = route(p, xt, cfg)
    # dispatch: (E*C+1, D), the last row the drop bucket; each kept slot
    # has one writer, so the copy is deterministic where it is read
    disp = torch.zeros((e * r.cap + 1, d), dtype=x.dtype, device=x.device)
    disp.index_copy_(0, r.slot, xt.repeat_interleave(k, dim=0))
    disp = constrain(disp[:e * r.cap].reshape(e, r.cap, d), "model", None,
                     None, role="moe_dispatch")
    out_e = constrain(expert_mlp(p, disp, cfg), "model", None, None,
                      role="moe_out")
    # combine
    flat_out = torch.cat([out_e.reshape(e * r.cap, d),
                          torch.zeros((1, d), dtype=x.dtype,
                                      device=x.device)])
    gathered = flat_out[r.slot].reshape(t, k, d)
    gathered = torch.where(r.keep[..., None], gathered, 0)
    out = (gathered * r.gates[..., None].to(x.dtype)).sum(1)
    # load-balance aux loss (Switch-style)
    frac_tokens = F.one_hot(r.experts, e).sum(1).float().mean(0)
    aux = e * (frac_tokens * r.probs.mean(0)).sum()
    # kept without its autograd graph: a graph held by the module would
    # keep a recomputed (remat) layer's saved activations alive after
    # the backward pass
    p.routing = r._replace(probs=r.probs.detach(), gates=r.gates.detach())
    return out.reshape(b, s, d), aux
