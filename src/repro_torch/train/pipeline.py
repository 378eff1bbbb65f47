"""Pipeline parallelism over stages (GPipe schedule): the port of
`repro/train/pipeline.py`, over a `torch.distributed` process group
where JAX maps over the "pod" axis (`train/comm.py`).

Stage s (the group rank) owns the port's layers [s*L/P, (s+1)*L/P) of
`model.blocks`, and microbatches stream stage to stage around a ring:
one boundary activation per microbatch per tick crosses a stage
boundary.  The loop is JAX's: n_micro + P - 1 ticks, and in each tick
every stage (a) takes microbatch t in if it is stage 0, (b) runs its
layers on its resident microbatch if one is there, (c) the last stage
emits a finished microbatch, (d) every stage passes its buffer to the
next one (`comm.ring_shift`: one `batch_isend_irecv` to (s+1) % P and
from (s-1) % P, JAX's `ppermute`).  The last stage's output is shared
with an all_reduce of it and the other stages' zeros (JAX's psum).
JAX computes every stage in every tick and selects; the port runs a
stage's layers only in the ticks where it holds a microbatch, which
gives the same values.  Bubble fraction = (P-1)/(n_micro+P-1).

Every rank holds the whole model (its stage's layers are the ones it
runs) and the whole activation stream, as JAX's replicated inputs.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from . import comm


def _stage_apply(blocks, x, cfg, positions):
    """Run one stage's layers (a mini `_backbone`: no final norm, no
    remat)."""
    for lp in blocks:
        x, _ = T._apply_slot(lp, x, cfg, positions, "train")
    return x


def make_pipelined_forward(cfg, group, n_micro: int):
    """forward(model, embeds (B,S,D)) -> hidden states (B,S,D) before the
    final norm, on every rank.

    Requires batch % n_micro == 0 and n_repeats % stages == 0 (JAX's
    asserts; ValueError here).
    """
    stages = comm.world(group)
    reps = T.n_repeats(cfg)
    if reps % stages:
        raise ValueError(f"{reps} repeat units do not split over {stages} "
                         "stages")
    per = cfg.n_layers // stages

    def forward(model, x):
        stage = comm.rank(group)
        blocks = model.blocks[stage * per:(stage + 1) * per]
        b, s, d = x.shape
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             "microbatches")
        mb = b // n_micro
        positions = torch.arange(s, device=x.device)[None].expand(mb, s)
        stream = x.reshape(n_micro, mb, s, d)
        buf = torch.zeros((mb, s, d), dtype=x.dtype, device=x.device)
        out = torch.zeros_like(stream)
        for t in range(n_micro + stages - 1):
            if stage == 0 and t < n_micro:       # stage 0 ingests t
                buf = stream[t]
            m = t - stage                        # microbatch id here
            if 0 <= m < n_micro:
                buf = _stage_apply(blocks, buf, cfg, positions)
            done_id = t - (stages - 1)           # the last stage emits
            if stage == stages - 1 and 0 <= done_id < n_micro:
                out[done_id] = buf
            buf = comm.ring_shift(buf, group)
        if stage != stages - 1:
            out.zero_()
        return comm.all_reduce(out, group=group).reshape(b, s, d)

    return forward


def pipelined_loss(cfg, group, n_micro: int):
    """CE loss using the pipelined backbone (embeds and labels on every
    rank).  Forward only: the ring's sends and receives record no
    autograd graph, so no gradient flows through it (JAX differentiates
    through `ppermute`); the backward is not ported."""
    fwd = make_pipelined_forward(cfg, group, n_micro)

    def loss_fn(model, batch):
        x = T._embed_inputs(model, batch, cfg)
        h = fwd(model, x)
        h = T._norm(cfg, model.final_ln, h)
        return T._chunked_ce(model, h, batch["labels"], cfg)

    return loss_fn
