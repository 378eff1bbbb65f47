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
next one (one `batch_isend_irecv` to (s+1) % P and from (s-1) % P,
JAX's `ppermute`).  The last stage's output is shared with an
all_reduce of it and the other stages' zeros (JAX's psum).  JAX
computes every stage in every tick and selects; the port runs a stage's
layers only in the ticks where it holds a microbatch, which gives the
same values.  Bubble fraction = (P-1)/(n_micro+P-1).

Every rank holds the whole model (its stage's layers are the ones it
runs) and the whole activation stream, as JAX's replicated inputs.

The loss is differentiable, with the gradient `jax.grad` gives JAX's:
the ring, the share and the replicated input are autograd functions
whose backwards are JAX's transposes (`comm.ring_shift_ad`, `share_ad`,
`replicated_ad`).  Each backward is a collective, so every rank's graph
has the same collective nodes: stage 0's ingest and the last stage's
emission are masks (`torch.where` on a tensor condition, JAX's
`jnp.where`), not replacements, so that no received buffer drops out of
a rank's graph; every rank's emitted microbatches go into the share.
The ring nodes are one a tick, each feeding the next tick, so the
engine runs their backwards last tick first on every rank, and the
sends and receives pair up (a mismatched pair would go unnoticed: the
buffers all have one shape).  The last tick's shift feeds nothing on
any rank, so no rank runs its backward.  After the backward each layer's
gradient is on the rank of its stage (zeros on the others), and the
embedding's, the final norm's and the head's are whole and equal on
every rank, where JAX's sit.  Differentiate with respect to every
parameter (`loss.backward()`, or `torch.autograd.grad` of them all): a
rank whose own parameters the graph does not reach would skip its
collectives.
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


def make_pipelined_forward(cfg, group, n_micro: int, stats=None):
    """forward(model, embeds (B,S,D)) -> hidden states (B,S,D) before the
    final norm, on every rank; differentiable (module docstring).

    stats: {"ring", "share", "input"} -> `comm.Stats` (any of them), the
    calls and bytes of the ring's shifts, the closing share and the
    replicated input's cotangent sum (backward only), forward and
    backward alike.  Requires batch % n_micro == 0 and n_repeats %
    stages == 0 (JAX's asserts; ValueError here).
    """
    stages = comm.world(group)
    reps = T.n_repeats(cfg)
    if reps % stages:
        raise ValueError(f"{reps} repeat units do not split over {stages} "
                         "stages")
    per = cfg.n_layers // stages
    stats = stats or {}

    def forward(model, x):
        stage = comm.rank(group)
        blocks = model.blocks[stage * per:(stage + 1) * per]
        b, s, d = x.shape
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             "microbatches")
        mb = b // n_micro
        positions = torch.arange(s, device=x.device)[None].expand(mb, s)
        x = comm.replicated_ad(x, group, stats.get("input"))
        stream = x.reshape(n_micro, mb, s, d)
        first = torch.tensor(stage == 0, device=x.device)
        last = torch.tensor(stage == stages - 1, device=x.device)
        buf = torch.zeros((mb, s, d), dtype=x.dtype, device=x.device)
        outs = []
        for t in range(n_micro + stages - 1):
            if t < n_micro:                      # stage 0 ingests t
                buf = torch.where(first, stream[t], buf)
            m = t - stage                        # microbatch id here
            if 0 <= m < n_micro:
                buf = _stage_apply(blocks, buf, cfg, positions)
            if t >= stages - 1:                  # the last stage emits
                outs.append(torch.where(last, buf, 0.0))   # t - (P - 1)
            buf = comm.ring_shift_ad(buf, group, stats.get("ring"))
        out = comm.share_ad(torch.stack(outs), group, stats.get("share"))
        return out.reshape(b, s, d)

    return forward


def pipelined_loss(cfg, group, n_micro: int, stats=None):
    """CE loss using the pipelined backbone (embeds and labels on every
    rank), the same on every rank, differentiable through the ring
    (module docstring): CE only (the MoE's aux is dropped, as JAX's
    `_stage_apply` drops it), MoE capacity per microbatch, no remat
    inside a stage.  stats: as `make_pipelined_forward`'s."""
    fwd = make_pipelined_forward(cfg, group, n_micro, stats)

    def loss_fn(model, batch):
        x = T._embed_inputs(model, batch, cfg)
        h = fwd(model, x)
        h = T._norm(cfg, model.final_ln, h)
        return T._chunked_ce(model, h, batch["labels"], cfg)

    return loss_fn
