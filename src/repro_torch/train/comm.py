"""Collectives for the explicit-collective trainers
(`train/ddp_shardmap.py`, `train/pipeline.py`): `torch.distributed`
process groups in place of JAX's `shard_map` axes.

Backend: gloo on the CPU; on the card NCCL when every rank has a card
of its own (`backend_for`).  NCCL refuses two ranks on one card, so on
a one-card machine the ranks share cuda:0 over gloo, and a CUDA tensor
goes through a pinned host buffer on its way to and from every gloo
collective (`_staged`): explicitly, never as a fallback after an error.

Without an initialised process group every collective is the one of a
world of one: the tensor as it is.  `Stats` adds up, per collective
call, the payload bytes (each tensor's size, as JAX's cost walk counts
them) and the seconds between a synchronise before the call and one
after it.

`ring_shift` and `all_reduce` record no autograd graph (the DDP step
and `no_grad` callers).  The pipeline's loss is differentiated through
`ring_shift_ad`, `share_ad` and `replicated_ad`, whose backwards are
JAX's transposes of `ppermute`, of `psum` to a replicated output and of
a replicated input, each one collective counted in its `Stats` like a
forward's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist


def backend_for(device, world: int) -> str:
    """gloo for CPU ranks; for CUDA ranks NCCL where `world` cards are
    visible (one a rank), else gloo (ranks sharing a card)."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device of `rank`: its own card under NCCL, else `device`."""
    device = torch.device(device)
    if device.type == "cuda" and backend == "nccl":
        return torch.device("cuda", rank)
    return device


def init_group(rank: int, world: int, port: int, device) -> str:
    """Join the default process group of `world` ranks at
    tcp://localhost:`port`; returns the backend."""
    backend = backend_for(device, world)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    return backend


def world(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


@dataclass
class Stats:
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None,
               stats: Stats | None = None) -> torch.Tensor:
    """`t` reduced over the group in place (JAX's psum / pmax); returns
    it."""
    if world(group) == 1:
        return t
    _sync(t)
    t0 = time.perf_counter()
    if _staged(t, group):
        h = _host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    _sync(t)
    if stats is not None:
        stats.calls += 1
        stats.bytes += t.numel() * t.element_size()
        stats.seconds += time.perf_counter() - t0
    return t


def _shift(t: torch.Tensor, group, stats: Stats | None,
           step: int) -> torch.Tensor:
    """`t` to rank (r + step) % P and the tensor of rank (r - step) % P
    back, in one `batch_isend_irecv`."""
    n = world(group)
    if n == 1:
        return t
    r = rank(group)
    to, frm = (r + step) % n, (r - step) % n
    if group is not None:
        to, frm = (dist.get_global_rank(group, to),
                   dist.get_global_rank(group, frm))
    _sync(t)
    t0 = time.perf_counter()
    staged = _staged(t, group)
    send = _host(t) if staged else t.contiguous()
    recv = torch.empty_like(send)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, to, group),
            dist.P2POp(dist.irecv, recv, frm, group)]):
        w.wait()
    out = recv.to(t.device) if staged else recv
    _sync(out)
    if stats is not None:
        stats.calls += 1
        stats.bytes += t.numel() * t.element_size()
        stats.seconds += time.perf_counter() - t0
    return out


def ring_shift(t: torch.Tensor, group=None,
               stats: Stats | None = None) -> torch.Tensor:
    """JAX's `ppermute` over the ring i -> (i + 1) % P: `t` goes to the
    next rank and the previous rank's tensor comes back, in one
    `batch_isend_irecv`.  Records no autograd graph (`ring_shift_ad`
    does)."""
    return _shift(t, group, stats, 1)


# ---------------------------------------------------------------------------
# the pipeline's collectives as autograd functions: each backward is JAX's
# transpose of the collective.  A backward runs a collective, so every rank
# must run the same backward nodes in the same order (train/pipeline.py).
# ---------------------------------------------------------------------------

class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, stats):
        ctx.group, ctx.stats = group, stats
        return _shift(t, group, stats, 1)

    @staticmethod
    def backward(ctx, ct):
        # ppermute's transpose is the inverse permutation: the cotangent
        # goes to (r - 1) % P and comes from (r + 1) % P
        return _shift(ct, ctx.group, ctx.stats, -1), None, None


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, stats):
        ctx.group, ctx.stats = group, stats
        ctx.mark_dirty(t)
        return all_reduce(t, group=group, stats=stats)

    @staticmethod
    def backward(ctx, ct):
        g = ct.clone(memory_format=torch.contiguous_format)
        return all_reduce(g, group=ctx.group, stats=ctx.stats) \
            / world(ctx.group), None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, stats):
        ctx.group, ctx.stats = group, stats
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        g = ct.clone(memory_format=torch.contiguous_format)
        return all_reduce(g, group=ctx.group, stats=ctx.stats), None, None


def ring_shift_ad(t: torch.Tensor, group=None,
                  stats: Stats | None = None) -> torch.Tensor:
    """`ring_shift` that autograd differentiates: the backward shifts the
    cotangent the other way round the ring (JAX's transpose of
    `ppermute`), counted in `stats` like the forward."""
    return _RingShift.apply(t, group, stats)


def share_ad(t: torch.Tensor, group=None,
             stats: Stats | None = None) -> torch.Tensor:
    """`t` summed over the ranks, in place, as an output that every rank
    holds whole (JAX's `psum` under a `shard_map` with out spec P()).
    The backward gives each rank psum(ct) / P: `shard_map` divides an
    unmapped output's cotangent by the axis size, and psum's transpose is
    psum (one all-reduce, counted in `stats`)."""
    return _Share.apply(t, group, stats)


def replicated_ad(t: torch.Tensor, group=None,
                  stats: Stats | None = None) -> torch.Tensor:
    """The identity on an input that every rank holds whole (JAX's in
    spec P()); the backward sums its cotangent over the ranks, JAX's
    transpose of a replicated input (one all-reduce, counted in
    `stats`)."""
    return _Replicated.apply(t, group, stats)
