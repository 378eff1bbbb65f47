"""Deterministic synthetic token pipeline with restart skip-ahead: the
port of `repro/data/synthetic.py`, numpy only.

Each data-parallel host generates its own shard of the global batch
from a counter-based RNG, so (a) no host ever reads another host's
data, (b) restarting at step k reproduces exactly the stream a failure
interrupted (a checkpoint stores only the step), and (c) elastic
re-sharding (another dp size) re-partitions the same logical stream.
Row `gidx` of the global stream draws from `np.random.default_rng((seed,
gidx))`, so the port's batches equal the JAX package's bit for bit.

The token distribution is a Zipf-like categorical with a deterministic
"document" structure (BOS every doc_len tokens): enough structure for
loss curves to be meaningful.  `batch()` returns numpy arrays; the
trainer moves them to its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    doc_len: int = 512


class SyntheticStream:
    """Stateless per-step batch generator (counter-based: skip-ahead)."""

    def __init__(self, cfg: DataConfig, dp_rank: int = 0, dp_size: int = 1):
        assert cfg.global_batch % dp_size == 0
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.local_batch = cfg.global_batch // dp_size
        # Zipf-ish unigram distribution, shared across hosts
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1)
        probs = 1.0 / ranks ** 1.1
        self._probs = probs / probs.sum()
        self._perm = rng.permutation(cfg.vocab)

    def batch(self, step: int) -> dict:
        """tokens/labels (local_batch, seq_len) int32 for global `step`."""
        c = self.cfg
        out_t = np.empty((self.local_batch, c.seq_len), np.int32)
        for row in range(self.local_batch):
            gidx = step * c.global_batch \
                + self.dp_rank * self.local_batch + row
            rng = np.random.default_rng((c.seed, gidx))   # counter-based
            toks = rng.choice(c.vocab, size=c.seq_len + 1, p=self._probs)
            toks = self._perm[toks]
            toks[:: c.doc_len] = 0                        # BOS structure
            out_t[row] = toks[:-1]
        labels = np.empty_like(out_t)
        labels[:, :-1] = out_t[:, 1:]
        labels[:, -1] = 0
        return {"tokens": out_t, "labels": labels}
