#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card (nvidia-smi name and power limit);
  2. build the seven kernels from src/repro_torch/kernels/csrc with nvcc
     (one nvcc per source, all at once, into the git-ignored
     src/repro_torch/kernels/_build/);
  3. every kernel against its plain PyTorch version on the card, bit for
     bit, at the main paths' shapes: divmod_batch at 2^15..2^18 bits with
     each Refine step and the finalization run through kernel AND plain
     version on the same inputs, synthetic adversarial Refine states at
     the 2^15-bit windows, at every cluster size (1/2/4/8 blocks per
     instance) and at a 2^18-bit modulus's W = 32778, the standalone
     product at 2^15 and 2^18 bits; the division's set-up
     (prologue_kernel) on every checked division, at both benchmark
     cells' shapes (2^15 bits x 131,072, 2^18 bits x 16,384, with edge
     lanes) and with h given at a 2^15-bit modulus's Barrett width;
     then the Barrett kernel on adversarial operands at 2^15- and
     2^17-bit moduli (lanes that take each correction branch, counted
     in the plain version) and at the real states of the modular path
     (precompute steps, reduce, modmul and a short modexp at 2^15/2^16/
     2^17-bit moduli); then the pair kernel (mul_pairs, mulmod_pairs) at
     the q*v shapes of the 2^15 x 256 and 2^18 x 32 division cells,
     divmod's u*shinv at 2^18 x 32, the 2^18-bit modulus's x*mu, the
     close product at l_max around the plain product's and the kernel's
     column-tile edges, and its in-launch carry chain: all-0xFFFF
     operands (every column tile waits for its carry-in), lanes just
     below and just above a tile's carry threshold, batches 1 and 256,
     and one 2^16 x 2^16-limb product;
  4. the division path: divmod_batch at 2^15/2^16/2^17/2^18 bits
     (batches 256/128/64/32), every lane checked against Python divmod
     and on the card as q*v + r == u, with exactly 2*refine_iters(M) + 2
     fused launches per division (the set-up, the Refine steps, the
     finalization) and the finalization on clusters of
     cluster_size(batch) blocks, then the division service answering
     three requests (one split across buckets);
  4b. a wide division: divmod_batch of 4 lanes at 30,000 limbs under
     cuda_fused (past the ~29,000 limbs the CUDA-core finalization
     staged), exact against Python, with divmod_launches(30000) + 1
     launches;
  4c. the divmod width cap under cuda_fused and cuda_batched, found by
     asking shinv.check_width (the kernel libraries' staging sizes):
     one limb past the cuda_fused cap, divmod_batch and the division
     service's constructor raise ValueError with no launch counted;
  5. the modular-arithmetic path: at 2^15/2^16/2^17-bit moduli the
     Barrett precompute (31/33/35 launches), reduce_shared and
     modmul_shared on 256/128/64 lanes (1 and 2 launches); at 2^15 bits
     reduce_batch and modmul_batch with 64 per-lane moduli and
     modexp_shared on 64 lanes with 256-bit exponents (674 launches);
     at a 2^18-bit modulus the precompute (36 launches), reduce_shared
     and modmul_shared on 4 lanes; every lane against Python % and pow;
     then ModArithService answering reduce, modmul and modexp requests
     against two interleaved moduli (one request split across buckets);
  5b. the frontend path: AsyncFrontend (impl cuda_fused) over the
     division service at 2^15 and 2^18 bits and ModArithService at a
     2^15-bit modulus, concurrent divmod, reduce, modmul and modexp
     (256-bit exponents) requests, every answer against Python, with no
     fault, retry, degradation or dropped request;
  5c. the pairs path: the services with impl cuda_pairs (divmod at 2^15
     and 2^18 bits, reduce, modmul and a short modexp at a 2^15-bit
     modulus, 4 reductions at a 2^18-bit modulus), exact, with the
     cost model's mul_pairs launches and no other kernel;
  5d. frontend chaos at 2^15 bits: a seeded compile fault degrades
     cuda_fused to cuda_batched, with answers bit-identical to 5b's; one
     on cuda_pairs has no rung below it on the card (the ladder never
     falls to the plain versions there), so its requests fail typed and
     launch nothing but their contexts' precompute; transient execute faults are retried; the
     quarantine set and the plans' degraded_from as planned, nothing
     dropped;
  6. timing with CUDA events (median of 5 after a warm-up): each kernel
     at each window it runs at (powdiff and update with their cluster
     size, limb products per second per SM and update's product columns
     kept; correct with its cluster size and limb products per second
     per SM over the clipped products), divmod_batch per precision (under cuda_fused and
     cuda_batched, with busy shares); per modulus size the precompute
     (also at 2^18 bits), reductions/s, modmuls/s, modexp (256-bit
     exponents) and exponentiations/s, the device's busy share, and the
     Barrett kernel
     (at the reduce and the 64-lane modexp shapes) and mul_batch (at
     modmul's a*b shape) per launch against their bounds, with the
     cluster size each used and its limb products per second per SM;
     mul_pairs beside mul_batch at the q*v shapes of the 2^15 x 256 and
     2^18 x 32 cells, with its limb products per second per SM, the
     whole call's busy share, divmod under cuda_pairs against cuda_fused
     in turns, and its library yardstick (also mul_batch's): the float64
     grouped conv1d of the column sums, checked exact; prologue_kernel
     at both benchmark cells' shapes (10 back-to-back launches) against
     its bytes bound and the ATen set-up's time.  ptxas registers
     and spills go to the report;
  6b. graph against eager: the services' bucket executables (one CUDA
     graph per (op, bucket, impl), serving/batching.py) at the division
     cells (cuda_fused at 2^15..2^18 bits, cuda_batched and cuda_pairs
     at 2^15 x 256 and 2^18 x 32) and the modular ones (precompute,
     reduce, modmul at 2^15/2^16/2^17-bit moduli, modexp on 64 lanes
     with 256-bit exponents), each replay timed against the eager call
     in turns (eager, graph, graph, eager; median of 5 CUDA-event
     timings after a warm-up, 3 for the unfused impls and the longer
     modexps) with the busy share of each, equal to eager and to the
     plain versions bit for bit, 3 replays counting 3x the cost model's
     launches, and each build's warm-up, capture and instantiate
     seconds and memory; a modexp with a full 2^15-bit exponent (the
     service's default e_limbs) as one graph; one service call per
     cuda_fused division cell and per modular op at 2^15 bits split
     into pack, copy-in, replay, copy-out and unpack; and the
     measured-vs-model table (obs/report.py) of every service, each
     row matching;
  7. the sharded path: a mesh of two shards (two cards where there are,
     else this card twice: each shard its own graph, pool and stream)
     under BigintDivisionService at 2^18 bits (a 64-row request, 32
     rows a shard, and a 96-row one split 64 + 32 across buckets) and
     ModArithService at a 2^15-bit modulus (reduce and modmul on 256
     rows, modexp on 64 rows with 256-bit exponents, two interleaved
     moduli): every lane exact and equal to the unsharded service's,
     shards x the cost model's launches per chunk (the graphs built
     first), one precompute per modulus, the measured-vs-model tables
     matching per shard; after phase 6b, both services' calls sharded
     and unsharded in turns (timing_sharded: a record, not a claim);
  8. the dry run: `repro_torch.launch.bigint_dryrun --limbs 16384
     --insts 8192` builds and replays one 32-row shard of the
     256-shard production layout at 2^18 bits: exact, with
     divmod_launches(16384) + 1 launches, a roofline equal to the sum of
     its launches' terms (obs/roofline.py over the cost model's work),
     its compile seconds and peak memory; the record goes to
     results/dryrun/bigint_div.json and into the report;
  9. LM serving (`repro_torch.models`, `repro_torch.launch.serve`),
     which launches none of the six kernels (the counts stay 0): (a)
     all ten archs, reduced, in float32, one set of weights on the CPU
     and a copy on the card: prefill logits (rtol = atol = 1e-4), 8
     greedy decode steps (1e-3, the bf16 KV cache) and their tokens
     against the CPU's (whisper over the cross cache its encoder fills
     from enc_seq frames; rwkv at 128 positions, its chunked WKV
     form); (b) smollm-135m, rwkv6-7b and whisper-medium at their
     published width and depth, phi3.5-moe at its published width with
     2 of 32 layers and jamba-1.5-large at its published widths in the
     2-layer ("m", "a") unit, in bf16, each built on the card from seed
     0, all but Jamba with a float32 copy of its weights: decode of a
     64-token prompt (128 for rwkv) against its prefill (the copy at
     JAX's 2e-2, the bf16 model at 2^-4; a MoE at a capacity that fits
     every slot, its decode steps given the prefill's expert ids so
     every row is compared; rwkv on its first 4, 8, 16 and 32 layers in
     float32 and its first 4 in bf16, each within its limit,
     LM_WKV_F32), every logit finite, 8 greedy steps of bf16 against the
     copy (logits within 2^-4, tokens equal where the copy's top-2
     margin is clear of that; not for rwkv);
     (c) prefill (4 x 2,048, 4 x 448 with the encoder over 4 x 1,500
     frames, 4 x 512) and decode (64 or 16 steps at batch 8 after the
     prefill's positions of history) timed with CUDA events, tokens/s,
     the device's busy share, peak memory, the dropped MoE slots at
     prefill and the bounds (`lm_bounds`), and one layer's chunked
     attention core against scaled_dot_product_attention where the arch
     has attention; (d) as child processes started together, `python -m
     repro_torch.launch.serve` for the LM demo (smollm, and rwkv6-7b)
     and `--bigint` (256 limbs x 64, "all exact"), and the long-context
     RWKV example.  The phase prints its seconds per part;
 10. LM training (`repro_torch.train`, `repro_torch.optim`,
     `repro_torch.checkpoint`), which launches none of the six kernels
     (the counts stay 0): (a) all ten archs, reduced, in float32, one
     set of weights on the CPU and a copy on the card: one
     train step on the same batch: the loss (rtol 1e-4), every gradient
     (rtol 1e-3, atol 1e-5 x the leaf's max; Jamba's bf16-stream leaves
     2^-8 x max), the AdamW update of the card's gradients (every new
     parameter, moment and the step) against the CPU's update of the
     same gradients, then a make_train_step step's loss on each;
     (b) smollm-135m
     at its published width and depth (30 layers, d 576, bf16, remat)
     trained 10 steps by `Trainer` on the synthetic stream at batch 8 x
     2,048 with AdamW in float32 state: every loss finite, the mean of
     the last 3 below the first, and the last async checkpoint restored
     onto the card bit for bit; (c) as child processes, `python -m
     repro_torch.launch.train` on the reduced smollm with
     --deterministic, once with a failure injected at step 12 and once
     without: equal final parameters (sha256), 1 and 0 restarts; (d)
     (b)'s step timed with CUDA events (median of 5 after 2 warm-ups),
     tokens/s, the device's busy share over 2 steps, peak memory and
     the bound from the shapes (`train_bound`); (e) as child processes
     started with (c), `python -m repro_torch.launch.train --arch
     smollm-135m --reduced --steps 20` and the e2e training example;
 11. LM distributed training (`repro_torch.train.ddp_shardmap`,
     `.pipeline`, `.comm`; `repro_torch.launch.dryrun`), which launches
     none of the six kernels (the counts stay 0): (c) first, as child
     processes started together, the dry run of qwen2-0.5b decode_32k
     on the multi-pod mesh and of smollm-135m train_4k on the single pod
     (status ok, peak under the card's 80 GB, three roofline terms > 0)
     and `python -m repro_torch.launch.train --arch smollm-135m
     --reduced --deterministic` with --mesh and without (equal
     sha256); then two ranks (`comm.backend_for`: NCCL on cards of
     their own, gloo through pinned host memory on one card) on
     smollm-135m at its published width and depth (bf16, remat): (a)
     `make_ddp_train_step` at a global batch of 8 x 2,048 (4 x 2,048 a
     rank) on the synthetic stream, DIST_STEPS steps with int8
     error-feedback compression and as many without (every loss finite,
     both curves falling over their first DIST_FALLING steps and over
     the run, the last losses within DIST_TOL_LAST of each other), each
     step timed with its collectives' ms and payload bytes; step 0's
     int8 exchange within half a quantization step of the float32 mean
     from the same gradients; and the uncompressed first two losses
     against one process's `make_train_step` on the global batch
     (within LM_TOL_BF16); (b)
     the GPipe forward over 2 stages of 15 layers in 4 microbatches of
     the same batch against the sequential layers on the same card
     (JAX's 2e-2), both timed; (b') the pipelined loss's gradient over
     the same 2 stages on a float32 copy of smollm-135m (30 layers, d
     576) at a global batch of 8 x 512 in 4 microbatches of 2 x 512,
     held on rank 0 against `make_grad_fn`'s on the same weights and
     batch (loss within PIPE_GRAD_TOL_LOSS relative, every leaf within
     PIPE_GRAD_TOL_LEAF x its max |g|), each layer's gradient on the rank
     of its stage (zeros on the other), the replicated leaves equal bit
     for bit on both ranks, the backward's ring, share and input
     collectives counted exactly; the pipelined forward + backward timed
     against the sequential gradient, with each rank's peak; (d) the dry
     run's one-card estimate of phase 10's step (a 1 x 1 mesh, 8 x
     2,048) beside phase 10's measured step and `train_bound`.

The services of phases 4, 5, 5b, 5c, 5d and 7 run through their bucket
graphs; where a phase counts a service call's launches exactly, it
builds the service's graphs first (`profile_bucket`), since a build's
eager warm-up launches too.  Phases 7, 8 and 9 run after 5d, and 7's
timing after 6b.

The kernel launch counters are set to 0 just before each of phases 4,
4b, 4c, 5, 5b, 5c, 5d, 7, 8, 9, 10 and 11 and read just after it.  Details go to
chiprun_out/chip_smoke.json.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, times and bounds.  Exits non-zero
without a result when there is no CUDA device or no src/repro_torch
beside it.  Before it exits, pass or fail, it stops every process it
started (the host pools' workers and multiprocessing's resource
tracker).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import multiprocessing
import os
import random
import signal
import statistics
import subprocess
import sys
import time
import types
from concurrent.futures import ProcessPoolExecutor
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PRECISIONS = ((2 ** 15, 256), (2 ** 16, 128), (2 ** 17, 64), (2 ** 18, 32))
# modulus bits and lanes of the modular-arithmetic path; a 2^18-bit
# modulus runs on MOD18_LANES lanes (the depth cut to the time limit)
MODULI = ((2 ** 15, 256), (2 ** 16, 128), (2 ** 17, 64))
MOD18_LANES = 4
# modexp exponent limbs: 256-bit exponents, the ladder's depth cut to
# fit the run's time limit (a full 2^15-bit exponent is ~41,000 modmuls)
E_LIMBS = 16
KERNELS = {
    "mul_batch": ("src/repro_torch/kernels/csrc/mul.cu",
                  "src/repro/kernels/bigmul.py:323"),
    "powdiff": ("src/repro_torch/kernels/csrc/step.cu",
                "src/repro/kernels/fused.py:441"),
    "update": ("src/repro_torch/kernels/csrc/step.cu",
               "src/repro/kernels/fused.py:454"),
    "correct": ("src/repro_torch/kernels/csrc/correct.cu",
                "src/repro/kernels/fused.py:468"),
    "barrett": ("src/repro_torch/kernels/csrc/barrett.cu",
                "src/repro/kernels/fused.py:486"),
    "mul_pairs": ("src/repro_torch/kernels/csrc/pairs.cu",
                  "src/repro/kernels/bigmul.py:114"),
    "prologue": ("src/repro_torch/kernels/csrc/prologue.cu",
                 "none: the JAX package's set-up is jnp glue "
                 "(src/repro/core/shinv.py)"),
}
# the division's set-up at the benchmark cells' shapes (bits, lanes):
# div15-ahead and div18-ahead
PROLOGUE_CELLS = ((2 ** 15, 131072), (2 ** 18, 16384))
GRID_TWINS = {"powdiff": "src/repro/kernels/fused.py:748",
              "update": "src/repro/kernels/fused.py:781",
              "correct": "src/repro/kernels/fused.py:810",
              "barrett": "src/repro/kernels/fused.py:854"}
# kernels each main path must launch
PATH_KERNELS = {"division_path": ("mul_batch", "prologue", "powdiff",
                                  "update", "correct"),
                "wide_division": ("prologue", "powdiff", "update",
                                  "correct"),
                "modarith_path": ("mul_batch", "prologue", "powdiff",
                                  "update", "barrett"),
                "frontend_path": ("mul_batch", "prologue", "powdiff",
                                  "update", "correct", "barrett"),
                "pairs_path": ("mul_pairs",),
                "frontend_chaos": ("mul_batch", "prologue", "powdiff",
                                   "update", "correct"),
                "sharded_path": ("mul_batch", "prologue", "powdiff",
                                 "update", "correct", "barrett"),
                "dryrun": ("prologue", "powdiff", "update", "correct"),
                "lm_serve": (),
                "lm_train": (),
                "lm_dist": ()}
# limbs at 2^15 and 2^18 bits, the sizes of the frontend and pair phases
M15, M18 = 2 ** 15 // 16, 2 ** 18 // 16
# the wide division's limbs, past the CUDA-core finalization's ~29,000
WIDE_LIMBS = 30000
# the sharded phase: rows of its division requests at 2^18 bits (64:
# 32 a shard, the 2^18 x 32 cell; 96 = 64 + 32 across buckets) and of
# its modular requests at a 2^15-bit modulus
SHARD_DIV_ROWS = (64, 96)
SHARD_MOD_ROWS = {"reduce": 256, "modmul": 256, "modexp": 64}
# the dry run: instances at 2^18 bits over the 256-shard layout (32 a
# shard)
DRYRUN_INSTS = 8192
# the frontend's requests at 2^15 bits (one split across buckets)
DIV_REQUESTS = (10, 70, 5)
MOD_REQUESTS = (("reduce", 70), ("modmul", 20), ("modexp", 12),
                ("reduce", 5))
# phase 9, LM serving: every registered arch (reduced, card against
# CPU), and five at published width: (arch, the config's cuts (none:
# the published depth), prefill batch x positions, decode batch and
# steps, whether a float32 copy is checked beside it).  The decode steps run at positions
# prefill..prefill + steps - 1 after a history of `prefill` positions:
# random bf16 K/V in the attention caches, random recurrent states, and
# whisper's cross cache filled by its encoder from random frames.
# Jamba's float32 copy (~48 GB beside its 24 GB) does not fit the card:
# its float32 check is the reduced one of (a).
LM_ARCHS = ("smollm-135m", "qwen2-0.5b", "starcoder2-3b", "nemotron-4-340b",
            "qwen2-vl-72b", "phi3.5-moe-42b-a6.6b", "arctic-480b",
            "rwkv6-7b", "jamba-1.5-large-398b", "whisper-medium")
LM_FULL = (("smollm-135m", {}, (4, 2048), 8, 64, True),
           ("phi3.5-moe-42b-a6.6b", {"n_layers": 2}, (4, 512), 8, 16, True),
           ("rwkv6-7b", {}, (4, 2048), 8, 16, True),
           ("whisper-medium", {}, (4, 448), 8, 16, True),
           ("jamba-1.5-large-398b", {"n_layers": 2, "layer_pattern":
                                     ("m", "a")}, (4, 512), 8, 16, False))
LM_PROMPT = 64          # decode against prefill: prompt positions
LM_PROMPT_CHUNKED = 128  # ... for RWKV: its chunked WKV prefill form
LM_GREEDY = 8           # bf16 against float32: greedy steps
# card against CPU (float32): prefill, then decode (the bf16 KV cache
# can round one element differently after a 1-ulp float32 difference)
LM_TOL_F32, LM_TOL_DECODE = 1e-4, 1e-3
# decode against prefill at full width in float32: JAX's own tolerance
# for the check (tests/test_archs.py:test_decode_matches_forward_attention,
# float32 configs)
LM_TOL_JAX = 2e-2
# bf16 at full width (decode against prefill, and against the float32
# copy): the two paths' GEMMs differ in shape and so round their bf16
# outputs differently, and 30 layers carry it to the logits (0.039 and
# 0.046-0.051 measured, NVIDIA H100 80GB HBM3, 700 W): 2^-4
LM_TOL_BF16 = 2 ** -4
# RWKV-6 at rwkv6-7b's full width, decode against prefill on the first n
# layers of the same weights (`transformer.first_layers`).  Two evaluation
# orders of a deep random-weight RWKV drift apart with depth, in JAX as
# in the port: float32 at 32 layers on the CPU on JAX's weights, 0.0026
# in JAX and 0.0045 in the port at d_model 512 (tests/test_torch_lm_rwkv
# .py::test_deep_decode_matches_prefill).  On the card the float32 copy
# read 4.3e-5, 3.2e-4, 0.0235 and 0.201 at 4, 8, 16 and 32 layers
# (NVIDIA H100 80GB HBM3, 700 W; the same on every run): it is held at
# JAX's tolerance where the reading lies under it and, deeper, at the
# next power of two above the reading (LM_WKV_F32, depth -> limit).  The
# bf16 model on the first LM_WKV_LAYERS layers read 0.090 (bf16 puts
# RWKV's logits 0.19 from float32's there, past LM_TOL_BF16): held at
# LM_TOL_WKV_BF16; at the full depth its logits finite.
# tests/test_torch_lm_rwkv.py holds the port's bf16 RWKV against JAX's.
LM_WKV_LAYERS = 4
LM_WKV_F32 = {4: LM_TOL_JAX, 8: LM_TOL_JAX, 16: 2 ** -5, 32: 2 ** -2}
LM_TOL_WKV_BF16 = 2 ** -3
# phase 10, LM training.  (a) card against CPU, float32, at batch 2 x 64
# positions (128 for rwkv, its chunked WKV form): the loss (rtol 1e-4);
# the gradients at the tolerances of tests/test_torch_train_model.py,
# rtol 1e-3 with atol 1e-5 x the leaf's max, and 2^-8 x max for the
# leaves Jamba's loss reaches only through its bf16 scan streams (a
# 1-ulp change moves them by up to 1.2e-3 x max); the AdamW update of
# the card's gradients on both devices, parameters rtol 1e-5 with atol
# 1e-5 lr, moments rtol 1e-5 with atol 1e-5 x max.  The update is held
# on the same gradients: AdamW moves a parameter by lr g / (|g| + eps),
# so a gradient element near eps = 1e-8 turns the 1e-5 x max the
# gradients may differ by into up to ~lr (0.045 lr read at qwen2-vl's
# wq, NVIDIA H100 80GB HBM3, 700 W).  Then one make_train_step step on
# each device from there: its loss (rtol 1e-4).
TRAIN_TOL_LOSS = 1e-4
TRAIN_TOL_GRAD = (1e-3, 1e-5)
TRAIN_STREAM_LEAVES = ("mamba.dt_bias", "mamba.a_log", "mamba.x_proj",
                       "mamba.dt_proj")
TRAIN_STREAM_ATOL = 2 ** -8
TRAIN_TOL_UPDATE = (1e-5, 1e-5)
TRAIN_LR = 3e-3
# (b) smollm-135m at its published width and depth: Trainer steps at
# batch x positions, a checkpoint every TRAIN_CKPT_EVERY steps; (d) its
# step timed after TRAIN_WARMUP steps
TRAIN_FULL = ("smollm-135m", 8, 2048)
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_WARMUP, TRAIN_TIMED = 10, 5, 2, 5
# phase 11, LM distributed training: smollm-135m at its published width
# and depth, a global batch x positions over DIST_RANKS ranks, DIST_STEPS
# steps each way; the GPipe forward over DIST_RANKS stages in PIPE_MICRO
# microbatches within JAX's tolerance (tests/test_pipeline.py); the
# dry-run cells (arch, shape, mesh) run as child processes.  The last
# losses with and without int8 error-feedback compression within JAX's
# bound (tests/test_system.py:160: 0.25 after 12 steps); each curve falls
# at each of its first DIST_FALLING steps and ends below its start (past
# them both level off near 6.7 and may rise a step).  On the card the
# compressed curve trails by up to 1.01 (step 4) and closes to -0.064 at
# step 12 (NVIDIA H100 80GB HBM3, 700 W): 40% of the nonzero gradient
# entries, 99.8% of the embedding's, quantize to 0 at step 0 and wait
# in the error buffer
DIST_FULL = ("smollm-135m", 8, 2048)
DIST_RANKS, DIST_STEPS, DIST_FALLING, PIPE_MICRO = 2, 12, 5, 4
DIST_TOL_LAST, PIPE_TOL = 0.25, 2e-2
# (b') the pipelined loss's gradient (`train/pipeline.py:pipelined_loss`)
# over the DIST_RANKS stages in PIPE_MICRO microbatches, on a float32 copy
# of the published config, held against `make_grad_fn`'s on rank 0: the
# loss within PIPE_GRAD_TOL_LOSS relative, each leaf within
# PIPE_GRAD_TOL_LEAF x its max |g|.  512 positions: a stage keeps every
# microbatch's activations (no remat inside a stage, JAX's
# `_stage_apply`), the chunked attention's float32 scores among them,
# about 120 KB a token a layer: ~7 GB a rank at 8 x 512, four times that
# a token at 2,048, past two ranks on one 80 GB card
PIPE_GRAD_FULL = ("smollm-135m", 8, 512)
PIPE_GRAD_TOL_LOSS, PIPE_GRAD_TOL_LEAF = 1e-5, 1e-4
PIPE_KINDS = ("ring", "share", "input")
DIST_DRYRUN = (("qwen2-0.5b", "decode_32k", "multi"),
               ("smollm-135m", "train_4k", "single"))


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def operands(m: int, batch: int, seed: int):
    """u, v lists of m-limb ints: adversarial lanes first (all-0xFFFF,
    v = B^k, one-limb divisor, u < v, v = 0), then random lanes with
    divisors of random length."""
    B = 1 << 16
    rnd = random.Random(seed)
    us = [rnd.getrandbits(16 * m) for _ in range(batch)]
    vs = [rnd.getrandbits(16 * rnd.randint(1, m)) | 1 for _ in range(batch)]
    x = rnd.getrandbits(16 * m)
    edges = [(B ** m - 1, B ** (m // 2) - 1), (B ** m - 1, B ** m - 1),
             (x, B ** (m // 2)), (x, 0xFFFF), (x, 3), (12345, B ** m - 1),
             (x, 0), (0, 7), (B ** m - 1, 0)]
    for i, (uu, vv) in enumerate(edges[:batch]):
        us[i], vs[i] = uu, vv
    return us, vs


def mod_operands(m: int, batch: int, seed: int):
    """Operands of the modular path at an m-limb modulus: a shared
    modulus with random limbs and its top limb set, per-lane moduli
    with the edges first (1, B^k, all-0xFFFF, one limb, 3) then random
    lengths; x < B^(2m) with edges (B^(2m) - 1, x < v, a multiple of
    v, 0); a, b < B^m; 256-bit exponents with edges (0, 1, all ones)."""
    B = 1 << 16
    rnd = random.Random(seed)
    v = rnd.getrandbits(16 * m) | 1 << (16 * m - 1)
    vs = [rnd.getrandbits(16 * rnd.randint(1, m)) | 1 for _ in range(batch)]
    vs[:5] = [1, B ** (m - 1), B ** m - 1, 0xFFFF, 3]
    xs = [rnd.getrandbits(32 * m) for _ in range(batch)]
    xs[:4] = [B ** (2 * m) - 1, 5, v * rnd.getrandbits(16 * m), 0]
    xs[5] = vs[5] * rnd.getrandbits(16 * m)
    a = [rnd.getrandbits(16 * m) for _ in range(batch)]
    a[:3] = [0, 1, B ** m - 1]
    b = [rnd.getrandbits(16 * m) for _ in range(batch)]
    b[2] = B ** m - 1
    e = [rnd.getrandbits(16 * E_LIMBS) for _ in range(batch)]
    e[:3] = [0, 1, B ** E_LIMBS - 1]
    return dict(v=v, vs=vs, x=xs, a=a, b=b, e=e)


def fused_only(impl):
    """The kernel-vs-plain checks route the default impl's launches."""
    if impl not in (None, "cuda_fused"):
        raise AssertionError(f"check routed impl {impl!r}")


def _pow(args):
    return pow(*args)


def _divmod(args):
    u, v = args
    return divmod(u, v) if v else (0, u)


def prec_of(x: int) -> int:
    """Significant base-2^16 limbs of x."""
    return -(-x.bit_length() // 16)


def host_map(fn, items) -> list:
    """fn over items on the host's cores (CPython's long division is
    quadratic: 0.7 s for one 256-bit exponent at a 2^15-bit modulus).
    The pool is closed before this returns."""
    items = list(items)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, len(items)),
                             mp_context=ctx) as pool:
        return list(pool.map(fn, items))


def pow_all(triples) -> list[int]:
    """pow(a, e, v) for each triple, on the host's cores."""
    return host_map(_pow, triples)


def child_pids() -> set[int]:
    """The live child processes of this process (any thread's)."""
    out = set()
    for task in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{task}/children") as f:
                out |= {int(p) for p in f.read().split()}
        except OSError:              # the thread ended meanwhile
            pass
    return out


def stop_children() -> list[int]:
    """Stop every process the script started before it exits.  The
    pools join their workers as they close, but the spawn start method
    also starts multiprocessing's resource tracker, which lives until
    it is stopped or sees this process end, and so would outlive the
    script.  Stop it and wait for it; kill and reap anything else still
    running.  Returns the pids that had to be killed."""
    for p in multiprocessing.active_children():
        p.join(timeout=30)
    from multiprocessing import resource_tracker
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    killed = sorted(child_pids())
    for pid in killed:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    return killed


def ptxas_report(path: Path) -> dict:
    """Registers and spill bytes of each kernel from nvcc's -Xptxas -v
    output, by kernel name."""
    import re
    out, name = {}, None
    text = path.read_text() if path.exists() else ""
    for line in text.splitlines():
        m = re.search(r"Function properties for _Z\d+(\w+?_kernel)(\w*)",
                      line)
        if m:
            # the step kernels' instantiations by team: <cluster>, <1 warp>
            name = m.group(1)
            t = re.search(r"ClusterTeam|WarpTeamILi(\d+)E", m.group(2))
            if t:
                name += (f"<{t.group(1)} warp>" if t.group(1)
                         else "<cluster>")
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def dist_exchange_witness(model, cfg, batch) -> dict:
    """Step 0's gradient exchange on this rank, both ways, from the same
    local gradients: the int8 error-feedback mean (zero error buffers)
    against the float32 mean, in quantization steps (amax over the ranks
    / 127; rounding bounds it by 1/2), and the share of this rank's
    nonzero entries that quantize to 0 and so wait in the error buffer,
    over all leaves and for the largest ones."""
    import torch
    import torch.distributed as dist
    from repro_torch.train import comm
    from repro_torch.train import ddp_shardmap as DDP
    from repro_torch.train.step import make_grad_fn
    _loss, _m, grads = make_grad_fn(cfg)(model, DDP._rows(batch, None))
    n = comm.world(None)
    worst, zeros, total, leaves = 0.0, 0, 0, {}
    for k, g in grads.items():
        g = g.float()
        plain = comm.all_reduce(g.clone(), dist.ReduceOp.SUM) / n
        quant, _err = DDP._quantized_psum(g, torch.zeros_like(g))
        step = comm.all_reduce(g.abs().max(), dist.ReduceOp.MAX) / 127.0
        worst = max(worst, ((quant - plain).abs().max() / step).item())
        nz = g != 0
        z, m = int((nz & (torch.round(g / step) == 0)).sum()), int(nz.sum())
        zeros, total = zeros + z, total + m
        leaves[k] = (g.numel(), z / max(m, 1))
    big = sorted(leaves.items(), key=lambda kv: -kv[1][0])[:4]
    return dict(worst_steps=worst, zero_share=zeros / total,
                largest={k: share for k, (_n, share) in big})


def dist_worker(rank: int, world: int, port: int, out: str, arch: str,
                batch: int, seq: int, steps: int, n_micro: int, lr: float,
                device: str = "cuda", reduced: bool = False) -> None:
    """One rank of phase 11 (a process of its own): (a) DDP steps with
    and without compression, (b) the GPipe forward and, on rank 0, the
    sequential layers it is held against; writes out/rank<r>.json."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import configs as C
    from repro_torch.data.synthetic import DataConfig, SyntheticStream
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import comm
    from repro_torch.train import pipeline as PL
    from repro_torch.train.ddp_shardmap import (init_error_buffers,
                                                make_ddp_train_step)
    backend = comm.init_group(rank, world, port, device)
    dev = comm.rank_device(device, rank, backend)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cfg = C.get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    ocfg = adamw.AdamWConfig(lr=lr, warmup_steps=2)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                        global_batch=batch))
    res = {"backend": backend, "device": str(dev), "rank": rank}
    model = T.init_params(cfg, 0, dev)
    res["exchange"] = dist_exchange_witness(
        model, cfg, {k: torch.from_numpy(v).to(dev, torch.long)
                     for k, v in stream.batch(0).items()})
    del model
    for compress in (True, False):
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        model = T.init_params(cfg, 0, dev)
        opt = adamw.init_state(dict(model.named_parameters()), ocfg)
        err = init_error_buffers(model)
        step = make_ddp_train_step(cfg, ocfg, compress=compress)
        rec = {k: [] for k in ("losses", "step_ms", "collective_ms",
                               "bytes", "calls")}
        for i in range(steps):
            b = {k: torch.from_numpy(v).to(dev, torch.long)
                 for k, v in stream.batch(i).items()}
            st = (step.stats.seconds, step.stats.bytes, step.stats.calls)
            sync()
            t0 = time.perf_counter()
            model, opt, err, loss = step(model, opt, err, b)
            loss = float(loss)
            sync()
            rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
            rec["losses"].append(loss)
            rec["collective_ms"].append(1e3 * (step.stats.seconds - st[0]))
            rec["bytes"].append(step.stats.bytes - st[1])
            rec["calls"].append(step.stats.calls - st[2])
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda \
            else None
        res["compressed" if compress else "plain"] = rec
        del model, opt, err
        if cuda:
            torch.cuda.empty_cache()
    model = T.init_params(cfg, 0, dev)
    tokens = torch.from_numpy(stream.batch(0)["tokens"]).to(dev, torch.long)
    fwd = PL.make_pipelined_forward(cfg, None, n_micro)
    with torch.no_grad():
        x = T._embed_inputs(model, {"tokens": tokens}, cfg)
        fwd(model, x)                             # warm-up
        ms = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            h = fwd(model, x)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
        pipe = {"pipeline_ms": ms, "layers_per_stage":
                cfg.n_layers // world, "microbatches": n_micro}
        if rank == 0:
            pos = torch.arange(seq, device=dev)[None].expand(batch, seq)
            PL._stage_apply(model.blocks, x, cfg, pos)  # warm-up
            sync()
            t0 = time.perf_counter()
            ref = PL._stage_apply(model.blocks, x, cfg, pos)
            sync()
            pipe["sequential_ms"] = 1e3 * (time.perf_counter() - t0)
            d = (h.float() - ref.float()).abs()
            pipe.update(max_abs_err=d.max().item(),
                        ref_max=ref.float().abs().max().item(),
                        within=bool(torch.allclose(h.float(), ref.float(),
                                                   rtol=PIPE_TOL,
                                                   atol=PIPE_TOL)),
                        finite=bool(torch.isfinite(h).all()))
    res["pipeline"] = pipe
    del model, x, h
    if cuda:
        torch.cuda.empty_cache()
    res["pipe_grad"] = dist_pipe_grad(rank, world, dev, out, n_micro,
                                      reduced)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def dist_pipe_grad(rank: int, world: int, dev, out: str, n_micro: int,
                   reduced: bool = False) -> dict:
    """(b') on one rank of a joined group: the pipelined loss and its
    gradient on a float32 copy of PIPE_GRAD_FULL's config, once to warm
    up and once timed with the backward's collectives counted (calls,
    bytes, seconds by kind); each rank's peak; whether the layers of the
    other stages got zeros.  Rank r > 0 saves the gradients it holds
    (its stage's layers, the replicated leaves) to out; after a barrier
    rank 0 times `make_grad_fn` on the same weights and batch and holds
    the pipelined loss and every leaf against it.  `reduced`: the
    reduced config at 4 x 32 (a rehearsal on CPU ranks)."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs as C
    from repro_torch.data.synthetic import DataConfig, SyntheticStream
    from repro_torch.models import transformer as T
    from repro_torch.train import comm
    from repro_torch.train import pipeline as PL
    from repro_torch.train.step import make_grad_fn
    arch, b, s = PIPE_GRAD_FULL
    cfg = C.get_config(arch)
    if reduced:
        cfg, b, s = cfg.reduced(), 4, 32
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype_str="float32")
    per = cfg.n_layers // world
    cuda = torch.device(dev).type == "cuda"
    model = T.init_params(cfg, 0, dev).requires_grad_(True)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=s,
                                        global_batch=b))
    batch = {k: torch.from_numpy(v).to(dev, torch.long)
             for k, v in stream.batch(0).items()}
    names, params = zip(*model.named_parameters())

    def stage_of(name):
        return int(name.split(".")[1]) // per \
            if name.startswith("blocks.") else None

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def run():
        stats = {k: comm.Stats() for k in PIPE_KINDS}
        sync()
        t0 = time.perf_counter()
        loss = PL.pipelined_loss(cfg, None, n_micro, stats)(model, batch)
        fwd = {k: (st.calls, st.bytes, st.seconds)
               for k, st in stats.items()}
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
        bwd = {k: dict(calls=st.calls - fwd[k][0],
                       bytes=st.bytes - fwd[k][1],
                       ms=1e3 * (st.seconds - fwd[k][2]))
               for k, st in stats.items()}
        return loss.detach(), dict(zip(names, grads)), ms, bwd

    run()                                        # warm-up
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    loss, grads, ms, bwd = run()
    res = dict(ms=ms, backward=bwd, loss=loss.item(),
               peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda
               else None,
               finite=all(bool(torch.isfinite(g).all())
                          for g in grads.values()),
               placed=all(not g.any() for k, g in grads.items()
                          if stage_of(k) not in (None, rank)),
               ticks=n_micro + world - 1, microbatches=n_micro,
               layers_per_stage=per, batch=b, seq=s, d_model=cfg.d_model)
    held = {k: g for k, g in grads.items() if stage_of(k) in (None, rank)}
    if rank:
        torch.save({k: g.cpu() for k, g in held.items()},
                   os.path.join(out, f"pipe_grads{rank}.pt"))
    del grads
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier()                   # every rank's activations are freed
    if rank == 0:
        grad_fn = make_grad_fn(cfg)
        grad_fn(model, batch)                    # warm-up
        sync()
        t0 = time.perf_counter()
        seq_loss, _m, seq = grad_fn(model, batch)
        sync()
        res["sequential_ms"] = 1e3 * (time.perf_counter() - t0)
        res["loss_rel"] = abs(loss.item() - seq_loss.item()) \
            / abs(seq_loss.item())
        res["sequential_loss"] = seq_loss.item()
        others = [torch.load(os.path.join(out, f"pipe_grads{r}.pt"))
                  for r in range(1, world)]
        owned = dict(held)
        equal = True
        for theirs in others:
            for k, g in theirs.items():
                g = g.to(dev)
                if stage_of(k) is None:
                    equal = equal and torch.equal(g, held[k])
                else:
                    owned[k] = g
        worst, worst_leaf = 0.0, None
        for k, want in seq.items():
            scale = want.abs().max().item()
            err = (owned[k] - want).abs().max().item() / max(scale, 1e-30)
            if err > worst:
                worst, worst_leaf = err, k
        res.update(worst_leaf_rel=worst, worst_leaf=worst_leaf,
                   replicated_equal=equal, leaves=len(seq))
    dist.barrier()
    return res


def pipe_grad_check(ranks) -> dict:
    """(b')'s check: the pipelined loss and every leaf against the
    sequential gradient within the stated tolerances, the gradients
    where JAX puts them, finite, and the backward's collectives
    counted exactly: the ring shifts once a tick but the last, the
    share and the replicated input once each."""
    pg = [r["pipe_grad"] for r in ranks]
    g0 = pg[0]
    b, s, d, ticks = g0["batch"], g0["seq"], g0["d_model"], g0["ticks"]
    buf = (b // g0["microbatches"]) * s * d * 4
    whole = b * s * d * 4
    want = {"ring": (ticks - 1, (ticks - 1) * buf), "share": (1, whole),
            "input": (1, whole)}
    for r, g in enumerate(pg):
        counts = {k: (g["backward"][k]["calls"],
                      g["backward"][k]["bytes"]) for k in PIPE_KINDS}
        if counts != want:
            raise AssertionError(f"rank {r}: the backward's collectives "
                                 f"{counts}, not {want}")
        if not (g["finite"] and g["placed"]) or g["loss"] != g0["loss"]:
            raise AssertionError(f"rank {r}: pipelined gradient {g}")
    if not (g0["loss_rel"] <= PIPE_GRAD_TOL_LOSS
            and g0["worst_leaf_rel"] <= PIPE_GRAD_TOL_LEAF
            and g0["replicated_equal"]):
        raise AssertionError(f"pipelined gradient against the "
                             f"sequential one: {g0}")
    summary = dict(
        ms=g0["ms"], sequential_ms=g0["sequential_ms"],
        loss=g0["loss"], sequential_loss=g0["sequential_loss"],
        loss_rel=g0["loss_rel"], worst_leaf_rel=g0["worst_leaf_rel"],
        worst_leaf=g0["worst_leaf"], leaves=g0["leaves"],
        backward=g0["backward"],
        peak_bytes=[g["peak_bytes"] for g in pg],
        stages=len(ranks), layers_per_stage=g0["layers_per_stage"],
        microbatches=g0["microbatches"], batch=b, seq=s,
        tol=dict(loss=PIPE_GRAD_TOL_LOSS, leaf=PIPE_GRAD_TOL_LEAF))
    log(f"lm_dist pipelined gradient, {PIPE_GRAD_FULL[0]} float32 over "
        f"{len(ranks)} stages of {g0['layers_per_stage']} layers, "
        f"batch {b} x {s} in {g0['microbatches']} microbatches: "
        f"forward + backward {g0['ms']:.1f} ms against the sequential "
        f"gradient's {g0['sequential_ms']:.1f} ms (rank 0 alone); loss "
        f"{g0['loss']:.6f} ({g0['loss_rel']:.2e} relative), worst leaf "
        f"{g0['worst_leaf']} {g0['worst_leaf_rel']:.2e} x its max |g|; "
        f"backward collectives {json.dumps(g0['backward'])}; peak a "
        f"rank {[g['peak_bytes'] for g in pg]} bytes")
    return summary


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    try:
        Smoke(torch, build).run()
    finally:
        killed = stop_children()
        if killed:
            print(f"chip_smoke: killed leftover processes {killed}",
                  file=sys.stderr)
    return 0


class Smoke:
    def __init__(self, torch, build):
        from repro_torch.core import arith, bigint, modarith, shinv
        from repro_torch.kernels import bigmul, digitmma, fused, ops
        from repro_torch.obs import costmodel, roofline
        from repro_torch.serving import errors, faults, frontend, policy
        from repro_torch.serving.bigint_service import BigintDivisionService
        from repro_torch.serving.modexp_service import ModArithService
        self.faults, self.frontend, self.policy = faults, frontend, policy
        self.errors = errors
        self.torch, self.build = torch, build
        self.A, self.bi, self.S, self.MA = arith, bigint, shinv, modarith
        self.F, self.K, self.CM, self.bigmul = fused, ops, costmodel, bigmul
        self.RL = roofline
        self.D = digitmma
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.Service, self.ModService = BigintDivisionService, ModArithService
        self.dev = torch.device("cuda", 0)
        self.err = {k: 0 for k in KERNELS}     # max |kernel - plain|
        self.checked = {k: 0 for k in KERNELS}
        self.record = {}                        # bits -> step/correct inputs
        self.report = {"phases": {}}

    # -- helpers ------------------------------------------------------------

    def tensor(self, xs, m):
        return self.bi.limbs_from_numpy(self.bi.batch_from_ints(xs, m),
                                        self.dev)

    def compare(self, name, got, want):
        torch = self.torch
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            d = (g.to(torch.int64) - w.to(torch.int64)).abs().max().item() \
                if g.numel() else 0
            self.err[name] = max(self.err[name], int(d))
        self.checked[name] += 1
        if self.err[name] != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version (max abs err {self.err[name]})")

    def time_ms(self, fn, runs=5):
        torch = self.torch
        fn()
        ts = []
        for _ in range(runs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    def run(self):
        torch = self.torch
        line = card_line()
        log(line)
        log(f"torch.cuda.get_device_name(): {torch.cuda.get_device_name(0)}")
        t0 = time.perf_counter()
        self.build.build_all()
        log(f"build: {self.build.build_seconds:.1f} s "
            f"({time.perf_counter() - t0:.1f} s with loading)")
        self.report["ptxas"] = ptxas_report(self.build.BUILD_DIR /
                                            "ptxas.log")
        log(f"ptxas: {json.dumps(self.report['ptxas'])}")
        self.phase("kernels_vs_plain", self.check_kernels)
        self.phase("barrett_vs_plain", self.check_barrett)
        self.phase("pairs_vs_plain", self.check_pairs)
        launches = {}
        for name, fn in (("division_path", self.main_path),
                         ("wide_division", self.wide_division),
                         ("modarith_path", self.modarith_path),
                         ("frontend_path", self.frontend_path),
                         ("pairs_path", self.pairs_path),
                         ("frontend_chaos", self.frontend_chaos),
                         ("sharded_path", self.sharded_path),
                         ("dryrun", self.dryrun),
                         ("lm_serve", self.lm_serve),
                         ("lm_train", self.lm_train),
                         ("lm_dist", self.lm_dist)):
            self.build.reset_launch_counts()
            self.phase(name, fn)
            got = self.build.launch_counts()
            log(f"{name} launches: {got}")
            for k in PATH_KERNELS[name]:
                if got.get(k, 0) < 1:
                    raise AssertionError(f"kernel {k} never launched on "
                                         f"the {name}")
            if not PATH_KERNELS[name] and any(got.values()):
                raise AssertionError(f"the {name} launched {got}: it "
                                     "runs none of the six kernels")
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            self.report.setdefault("path_launches", {})[name] = got
            if name == "wide_division":
                self.phase("width_cap", self.width_cap)
        self.phase("timing", self.timing)
        self.phase("timing_prologue", self.timing_prologue)
        self.phase("timing_pairs", self.timing_pairs)
        self.phase("timing_modarith", self.timing_modarith)
        self.phase("graphs", self.graphs)
        self.phase("timing_sharded", self.timing_sharded)
        kernels = self.kernel_line(launches)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        self.report.update(card=line, kernels=kernels,
                           device=torch.cuda.get_device_name(0))
        (out / "chip_smoke.json").write_text(json.dumps(self.report,
                                                        indent=1))
        log(line)
        log(json.dumps({"kernels": kernels}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))

    def phase(self, name, fn):
        t0 = time.perf_counter()
        log(f"== {name}")
        fn()
        dt = time.perf_counter() - t0
        self.report["phases"][name] = dt
        log(f"== {name} done in {dt:.1f} s")

    # -- phase 3: every kernel against its plain version --------------------

    @contextmanager
    def checking(self, bits):
        """Route the Refine steps and the finalization of divmod_batch
        through kernel AND plain version on the same inputs; record the
        inputs for the timing phase."""
        F, K = self.F, self.K
        rec = self.record.setdefault(bits, {"step": [], "correct": None})
        orig = K.fused_step, K.fused_correct

        def step(v, w, *, h, m, l, s, active, g, win, impl=None):
            fused_only(impl)
            hpd, lpd = h - m, l - g
            sk, xk = F.powdiff_cuda(v, w, hpd, lpd, s, win=win)
            self.compare("powdiff", (sk, xk),
                         F.powdiff_reference(v, w, hpd, lpd, s, win=win))
            out = F.update_cuda(w, xk, sk, h, m, active, win=win)
            self.compare("update", (out,), (F.update_reference(
                w, xk, sk, h, m, active, win=win),))
            rec["step"].append(dict(v=v, w=w, hpd=hpd, lpd=lpd, s=s, x=xk,
                                    sign=sk, h=h, m=m, active=active,
                                    win=win))
            return out

        def correct(u, v, si, *, h, impl=None):
            fused_only(impl)
            got = F.correct_cuda(u, v, si, h=h)
            self.compare("correct", got, F.correct_reference(u, v, si, h=h))
            rec["correct"] = dict(u=u, v=v, si=si, h=h)
            return got

        def prologue(v, *, h=None, u=None):
            got = orig_prologue(v, h=h, u=u)
            self.compare("prologue", self.set_up(got),
                         self.set_up(self.S.prologue_plain(v, h, u)))
            return got

        orig_prologue = F.prologue_cuda
        K.fused_step, K.fused_correct = step, correct
        F.prologue_cuda = prologue
        try:
            yield
        finally:
            K.fused_step, K.fused_correct = orig
            F.prologue_cuda = orig_prologue

    def check_kernels(self):
        torch, F, K = self.torch, self.F, self.K
        B = 1 << 16
        # the standalone product at 2^15 bits and at 2^18 bits
        for wu, wo, batch in ((2056, 4112, 64), (16384, 32768, 2)):
            xs, ys = operands(wu, batch, wu)
            u, v = self.tensor(xs, wu), self.tensor(ys, wu)
            got = K.mul_batch(u, v, wo)
            self.compare("mul_batch", (got,), (K.mul_plain(u, v, wo),))
            for x, y, z in zip(xs[:3], ys[:3], self.bi.batch_to_ints(got)):
                assert z == (x * y) % B ** wo
            log(f"mul_batch {wu}x{wu}->{wo} limbs, batch {batch}: exact")
        # synthetic Refine states at windows of the 2^15-bit schedule
        full_w = 2048 + self.S.PAD
        for win in (32, 528, 1040, 2056):
            st = self.synthetic_states(full_w, win, 24, win)
            sk, xk = F.powdiff_cuda(st["v"], st["w"], st["hpd"], st["lpd"],
                                    st["s"], win=win)
            self.compare("powdiff", (sk, xk), F.powdiff_reference(
                st["v"], st["w"], st["hpd"], st["lpd"], st["s"], win=win))
            args = (st["w"], xk, sk, st["h"], st["m"], st["active"])
            self.compare("update", (F.update_cuda(*args, win=win),),
                         (F.update_reference(*args, win=win),))
            log(f"powdiff+update synthetic states, win {win}: exact")
        # every cluster size, a 2^18-bit modulus's full window (4 lanes,
        # the cluster of the precompute's single lane), and the packed
        # steps at 2^18 bits (W 16,392) on a batch past 1.5 lanes an SM
        packed = [(301, 16384 + self.S.PAD, w) for w in (32, 272, 528, 1040)]
        for batch, fw, win in [(256, full_w, 528), (100, full_w, 528),
                               (64, full_w, 528), (5, full_w, 528),
                               (4, 32778, 32778)] + packed:
            st = self.synthetic_states(fw, win, batch, batch + win)
            sk, xk = F.powdiff_cuda(st["v"], st["w"], st["hpd"], st["lpd"],
                                    st["s"], win=win)
            self.compare("powdiff", (sk, xk), F.powdiff_reference(
                st["v"], st["w"], st["hpd"], st["lpd"], st["s"], win=win))
            args = (st["w"], xk, sk, st["h"], st["m"], st["active"])
            self.compare("update", (F.update_cuda(*args, win=win),),
                         (F.update_reference(*args, win=win),))
            cs = self.D.cluster_size(batch, self.sms)
            got = (self.D.last_cluster["powdiff"],
                   self.D.last_cluster["update"])
            self.expect(f"step clusters at batch {batch}", got, (cs, cs))
            lib = self.build.lib("step")
            plan = self.D.step_plan(win, batch, self.sms,
                                    lib.step_lane_bytes(win),
                                    lib.step_pack_threads())
            lanes = plan.lanes if plan else 1
            got = (self.D.last_lanes["powdiff"], self.D.last_lanes["update"])
            self.expect(f"step lanes a block at batch {batch}, win {win}",
                        got, (lanes, lanes))
            if (batch, fw, win) in packed:
                self.expect(f"packed at batch {batch}, W {fw}, win {win}",
                            lanes > 1, True)
            log(f"powdiff+update synthetic states, win {win}, batch "
                f"{batch}, cluster {cs}, "
                f"{self.D.last_lanes['update']} lanes a block: exact")
        # the finalization at W = 2056 around the true shifted inverse
        W = full_w
        rnd = random.Random(5)
        us, vs = operands(W - 8, 32, 7)
        hs = [-(-x.bit_length() // 16) for x in us]
        sis = [max(0, B ** h // y + rnd.randint(-1, 1)) % B ** W if y else 0
               for h, y in zip(hs, vs)]
        u, v, si = self.tensor(us, W), self.tensor(vs, W), self.tensor(sis, W)
        h = torch.tensor(hs, dtype=torch.int32, device=self.dev)
        self.compare("correct", F.correct_cuda(u, v, si, h=h),
                     F.correct_reference(u, v, si, h=h))
        log(f"correct W {W}: exact")
        # real states: every step and finalization of each precision
        for bits, batch in PRECISIONS:
            m = bits // 16
            us, vs = operands(m, batch, bits)
            u, v = self.tensor(us, m), self.tensor(vs, m)
            with self.checking(bits):
                q, r = self.S.divmod_batch(u, v)
            self.compare("mul_batch", (K.mul_batch(q, v, m),),
                         (K.mul_plain(q, v, m),))
            self.check_exact(us, vs, q, r)
            log(f"divmod 2^{bits.bit_length() - 1} bits batch {batch}: "
                f"kernels == plain on every step, exact")
        self.check_prologue()
        log(f"kernel-vs-plain comparisons: {self.checked}, max abs err "
            f"{self.err}")
        self.report["checked"] = dict(self.checked)

    def set_up(self, out):
        """A set-up's outputs (`prologue_cuda`, `prologue_plain`) as a
        tuple of tensors: the limb arrays, the scalars and the flags."""
        torch = self.torch
        return tuple(t for t in out[:4] if t is not None) + (
            torch.stack(tuple(out[4])), torch.stack(tuple(out[5])))

    def cell_operands(self, m, batch, seed):
        """Division operands at a benchmark cell's shape, drawn on the
        card as its traffic draws them (prec(u) = m - 2, prec(v) uniform
        in [2, m / 2]), with edge lanes first: v = 0, 1, 0xFFFF, B^h / 2
        (so 2v = B^h, h = prec(u)), B^h / 2 + 1, and u = 0."""
        torch, dev = self.torch, self.dev
        g = torch.Generator(device=dev).manual_seed(seed)
        idx = torch.arange(m, device=dev)

        def draw(prec):
            x = torch.randint(0, 1 << 16, (batch, m), generator=g,
                              device=dev, dtype=torch.int32)
            x = torch.where(idx < prec[:, None], x, 0)
            top = torch.randint(1, 1 << 16, (batch, 1), generator=g,
                                device=dev, dtype=torch.int32)
            return x.scatter_(1, (prec - 1)[:, None].long(), top)

        u = draw(torch.full((batch,), m - 2, device=dev))
        v = draw(torch.randint(2, m // 2 + 1, (batch,), generator=g,
                               device=dev))
        v[:5] = 0
        v[1, 0], v[2, 0] = 1, 0xFFFF
        v[3, m - 3], v[4, m - 3], v[4, 0] = 0x8000, 0x8000, 1
        u[5] = 0
        return u, v

    def check_prologue(self):
        """prologue_kernel against the ATen set-up at both benchmark
        cells' shapes (the divmod entry) and at a 2^15-bit modulus's
        Barrett width (the precompute's entry, h given), bit for bit."""
        F, S, torch = self.F, self.S, self.torch
        for bits, batch in PROLOGUE_CELLS:
            m = bits // 16
            u, v = self.cell_operands(m, batch, bits)
            self.compare("prologue", self.set_up(F.prologue_cuda(v, u=u)),
                         self.set_up(S.prologue_plain(v, u=u)))
            log(f"prologue 2^{bits.bit_length() - 1} bits x {batch}: "
                f"exact")
            del u, v
            torch.cuda.empty_cache()
        m = M15
        W = self.MA.barrett_width(m)
        _, v = self.cell_operands(W, 256, 7)
        h = torch.full((256,), self.MA.barrett_h(m), dtype=torch.int32,
                       device=self.dev)
        h[:8] = torch.tensor([0, 1, W - 1, W, W + 3, -1, W // 2, 2])
        self.compare("prologue", self.set_up(F.prologue_cuda(v, h=h)),
                     self.set_up(S.prologue_plain(v, h)))
        log(f"prologue with h given, W {W} x 256: exact")

    def synthetic_states(self, full_w, win, batch, seed):
        """Random iterates and Refine scalars with adversarial lanes:
        all-0xFFFF and zero operands, B^k iterates, inactive lanes."""
        torch, B = self.torch, 1 << 16
        rnd = random.Random(seed)
        vs = [B ** full_w - 1, 0, B ** full_w - 1, B ** (full_w // 2)] + [
            rnd.getrandbits(16 * full_w) for _ in range(batch - 4)]
        ws = [B ** win - 1, 0, B ** (win - 1), B ** win - 1] + [
            rnd.getrandbits(16 * rnd.randint(1, win)) for _ in range(batch - 4)]
        ls = [rnd.randint(2, max(2, win // 2)) for _ in range(batch)]
        ms = [rnd.randint(0, l_) for l_ in ls]
        hs = [rnd.randint(1, 2 * win - 1) for _ in range(batch)]
        col = lambda xs: torch.tensor(xs, dtype=torch.int32, device=self.dev)
        h, m, l = col(hs), col(ms), col(ls)
        return dict(v=self.tensor(vs, full_w), w=self.tensor(ws, full_w),
                    hpd=h - m, lpd=l - 2, h=h, m=m,
                    s=col([rnd.randint(0, 3) for _ in range(batch)]),
                    active=col([i % 5 != 4 for i in range(batch)]).bool())

    def check_exact(self, us, vs, q, r):
        """Every lane against Python divmod, and q*v + r == u on the card
        (the product through the port's mul_batch entry point)."""
        A, K = self.A, self.K
        m = q.shape[1]
        qv = K.mul_batch(q, self.tensor(vs, m), m)
        if not self.torch.equal(A.add(qv, r), self.tensor(us, m)):
            raise AssertionError("q*v + r != u on the card")
        for x, y, qq, rr in zip(us, vs, self.bi.batch_to_ints(q),
                                self.bi.batch_to_ints(r)):
            if (qq, rr) != (divmod(x, y) if y else (0, x)):
                raise AssertionError(f"divmod wrong for u={x:#x} v={y:#x}")

    # -- phase 4: the main path ---------------------------------------------

    def main_path(self):
        torch, CM = self.torch, self.CM
        self.main_inputs = {}
        for bits, batch in PRECISIONS:
            m = bits // 16
            us, vs = operands(m, batch, bits + 1)
            u, v = self.tensor(us, m), self.tensor(vs, m)
            before = self.build.launch_counts()
            q, r = self.S.divmod_batch(u, v)
            torch.cuda.synchronize()
            after = self.build.launch_counts()
            moved = {k: after.get(k, 0) - before.get(k, 0)
                     for k in ("prologue", "powdiff", "update", "correct")}
            it = CM.refine_iters(m)
            want = CM.divmod_launches(m) + CM.prologue_launches()
            if (moved != {"prologue": 1, "powdiff": it, "update": it,
                          "correct": 1}
                    or sum(moved.values()) != want):
                raise AssertionError(f"2^{bits.bit_length() - 1} bits: "
                                     f"launches {moved}, expected {want}")
            self.expect(f"correct cluster at 2^{bits.bit_length() - 1} "
                        f"bits", self.D.last_cluster["correct"],
                        self.D.cluster_size(batch, self.sms))
            self.check_exact(us, vs, q, r)
            self.main_inputs[bits] = (u, v, q)
            log(f"divmod_batch 2^{bits.bit_length() - 1} bits, batch "
                f"{batch}: {sum(moved.values())} fused launches, every "
                f"lane exact")
        svc = self.Service(m_limbs=2048, batch_buckets=(16, 64),
                           device=self.dev)
        for n in (10, 64, 100):                  # 100 = 64 + 36: two chunks
            us, vs = operands(2048, n, 7 * n)
            qs, rs = svc.divide(us, vs)
            for x, y, qq, rr in zip(us, vs, qs, rs):
                if (qq, rr) != (divmod(x, y) if y else (0, x)):
                    raise AssertionError("service answer wrong")
        st = svc.stats()
        log(f"service m_limbs=2048: {st['requests']} requests, "
            f"{st['rows_true']} rows in {st['rows_padded']} padded, exact")
        self.report["service"] = st

    # -- phases 4b and 4c: a wide division and the width cap -----------------

    def wide_division(self):
        """divmod_batch of 4 lanes at WIDE_LIMBS limbs under cuda_fused:
        divmod_launches(WIDE_LIMBS) launches, every lane against Python
        divmod."""
        m = WIDE_LIMBS
        us, vs = operands(m, 4, m)
        u, v = self.tensor(us, m), self.tensor(vs, m)
        t0 = time.perf_counter()
        (q, r), got = self.launched_by(lambda: self.S.divmod_batch(u, v))
        dt = time.perf_counter() - t0
        it = self.CM.refine_iters(m)
        self.expect(f"divmod {m} limbs launches", got,
                    {"prologue": 1, "powdiff": it, "update": it,
                     "correct": 1})
        self.expect(f"divmod {m} limbs launch total", sum(got.values()),
                    self.CM.divmod_launches(m)
                    + self.CM.prologue_launches())
        want = host_map(_divmod, zip(us, vs))
        if list(zip(self.bi.batch_to_ints(q),
                    self.bi.batch_to_ints(r))) != want:
            raise AssertionError(f"divmod at {m} limbs inexact")
        log(f"divmod_batch {m} limbs x 4 under cuda_fused: "
            f"{sum(got.values())} launches ({dt:.2f} s), correct cluster "
            f"{self.D.last_cluster['correct']}, every lane exact")
        self.report["wide_division"] = dict(limbs=m, lanes=4, seconds=dt,
                                            launches=got)

    def width_cap(self):
        """The widest division each staging impl takes on this card, by
        bisecting shinv.check_width (it asks the kernel libraries); one
        limb past the cuda_fused cap, divmod_batch and the division
        service raise ValueError and no kernel is launched."""
        S, torch = self.S, self.torch

        def fits(m, impl):
            try:
                S.check_width(self.dev, m, impl)
                return True
            except ValueError:
                return False

        caps = {}
        for impl in ("cuda_fused", "cuda_batched"):
            lo, hi = 1, self.D.MAX_LIMBS     # fits at lo, not at hi
            while hi - lo > 1:
                mid = (lo + hi) // 2
                lo, hi = (mid, hi) if fits(mid, impl) else (lo, mid)
            caps[impl] = lo
        self.build.reset_launch_counts()
        past = caps["cuda_fused"] + 1
        wide = torch.ones(2, past, dtype=torch.int32, device=self.dev)
        for what, fn in (
                ("divmod_batch", lambda: S.divmod_batch(wide, wide)),
                ("BigintDivisionService", lambda: self.Service(
                    m_limbs=past, batch_buckets=(2,), device=self.dev))):
            try:
                fn()
            except ValueError as exc:
                log(f"{what} at {past} limbs: ValueError: {exc}")
            else:
                raise AssertionError(f"{what} took {past} limbs")
        self.Service(m_limbs=past, batch_buckets=(2,), device=self.dev,
                     impl="cuda_pairs")
        self.expect("launches past the cap", self.build.launch_counts(), {})
        log(f"divmod width caps (limbs): {caps}; past the cuda_fused cap "
            f"nothing launched")
        self.report["divmod_width_caps"] = caps

    # -- phase 5: timing -----------------------------------------------------

    def bound(self, products, nbytes):
        """(ms, "operations" or "bytes"): obs/roofline.py's bound."""
        s, by = self.RL.bound(products, nbytes)
        return s * 1e3, by

    def timing(self):
        """Per precision: each kernel launch of the recorded divmod_batch
        (every Refine window, the finalization) and the q*v product,
        timed with CUDA events around the wrapper call (host cost
        included) and by the profiler on the device; the plain versions
        at 2^15 bits; divmod_batch end to end with its device busy
        share."""
        F, K, S = self.F, self.K, self.S
        rows, agg = [], {}
        self.step_full, self.correct_cells = {}, {}
        for bits, batch in PRECISIONS:
            rec, first = self.record[bits], bits == PRECISIONS[0][0]
            items = []                    # (row, kernel, fn, plain, work)
            for i, st in enumerate(rec["step"]):
                win, fw = st["win"], st["v"].shape[1]
                act = int(st["active"].sum())
                pd_args = (st["v"], st["w"], st["hpd"], st["lpd"], st["s"])
                up_args = (st["w"], st["x"], st["sign"], st["h"], st["m"],
                           st["active"])
                row = dict(bits=bits, batch=batch, iter=i, win=win,
                           active=act)
                # limb products and bytes (obs/costmodel.py) on these
                # lanes' significant limbs
                pd, up, kept = self.step_work(st)
                row["update_columns_kept"] = kept
                items.append((row, "powdiff",
                              lambda a=pd_args, w=win: F.powdiff_cuda(
                                  *a, win=w),
                              lambda a=pd_args, w=win: F.powdiff_reference(
                                  *a, win=w),
                              pd))
                items.append((row, "update",
                              lambda a=up_args, w=win: F.update_cuda(
                                  *a, win=w),
                              lambda a=up_args, w=win: F.update_reference(
                                  *a, win=w),
                              up))
            c = rec["correct"]
            W = c["u"].shape[1]
            cargs = (c["u"], c["v"], c["si"])
            u, v, q = self.main_inputs[bits]
            m = u.shape[1]
            tail = dict(bits=bits, batch=batch)
            items.append((tail, "correct",
                          lambda: F.correct_cuda(*cargs, h=c["h"]),
                          lambda: F.correct_reference(*cargs, h=c["h"]),
                          self.correct_work(c)))
            items.append((tail, "mul_batch", lambda: K.mul_batch(q, v, m),
                          lambda: K.mul_plain(q, v, m),
                          self.CM.mul_work(batch, m, m, m)))
            dev = self.device_us([it[2] for it in items])
            last = len(rec["step"]) - 1          # the full-window launch
            for j, (row, name, fn, plain, work) in enumerate(items):
                row[f"{name}_ms"] = self.time_ms(fn)
                row[f"{name}_device_ms"] = dev[j] / 1e3 if dev else None
                row[f"{name}_bound_ms"] = self.bound(*work)[0]
                if name == "correct":
                    row.update(correct_products=work[0],
                               correct_cluster=self.D.last_cluster[name],
                               correct_burst_ms=self.burst_ms(fn, n=10))
                    ms = row["correct_device_ms"] or row["correct_burst_ms"]
                    row["correct_rate_per_sm"] = self.rate(work[0], ms)
                    self.correct_cells[bits] = dict(
                        shape=f"2^{bits.bit_length() - 1} bits x {batch}",
                        device_ms=row["correct_device_ms"],
                        burst_ms=row["correct_burst_ms"],
                        event_ms=row["correct_ms"],
                        bound_ms=row["correct_bound_ms"],
                        cluster=row["correct_cluster"],
                        rate_per_sm=row["correct_rate_per_sm"],
                        products=work[0])
                    pt = self.report["ptxas"].get("correct_kernel", {})
                    log(f"correct 2^{bits.bit_length() - 1} bits x {batch}: "
                        f"cluster {row['correct_cluster']}, device "
                        f"{row['correct_device_ms']} ms (burst "
                        f"{row['correct_burst_ms']:.4f}), bound "
                        f"{row['correct_bound_ms']:.4f} ms, "
                        f"{row['correct_rate_per_sm']:.3g} limb products/s "
                        f"per SM, ptxas {pt.get('registers')} registers, "
                        f"{pt.get('spill_stores')}/{pt.get('spill_loads')} "
                        f"spill bytes")
                if name in ("powdiff", "update"):
                    row[f"{name}_products"] = work[0]
                    row[f"{name}_cluster"] = self.D.last_cluster[name]
                    row[f"{name}_lanes"] = self.D.last_lanes[name]
                    if row["iter"] == last:
                        row[f"{name}_burst_ms"] = self.burst_ms(fn, n=10)
                    ms = row[f"{name}_device_ms"] or row.get(
                        f"{name}_burst_ms")
                    row[f"{name}_rate_per_sm"] = self.rate(work[0], ms)
                    if row["iter"] == last:
                        self.step_full.setdefault(bits, {})[name] = dict(
                            shape=f"full-window launch, {win} limbs, "
                            f"2^{bits.bit_length() - 1} bits x {batch}",
                            device_ms=row[f"{name}_device_ms"],
                            burst_ms=row[f"{name}_burst_ms"],
                            event_ms=row[f"{name}_ms"],
                            bound_ms=row[f"{name}_bound_ms"],
                            cluster=row[f"{name}_cluster"],
                            rate_per_sm=row[f"{name}_rate_per_sm"],
                            products=work[0])
                if first:
                    row[f"{name}_plain_ms"] = self.time_ms(plain)
                    a = agg.setdefault(name, dict(
                        event_ms=0.0, device_ms=0.0 if dev else None,
                        plain_ms=0.0, products=0, bytes=0, launches=0))
                    a["launches"] += 1
                    a["event_ms"] += row[f"{name}_ms"]
                    if dev:
                        a["device_ms"] += row[f"{name}_device_ms"]
                    a["plain_ms"] += row[f"{name}_plain_ms"]
                    a["products"] += work[0]
                    a["bytes"] += work[1]
                    if name in ("powdiff", "update", "correct"):
                        a["cluster"] = row[f"{name}_cluster"]
            for row in dict((id(it[0]), it[0]) for it in items).values():
                if row is tail:
                    dm = self.time_ms(lambda: S.divmod_batch(u, v))
                    row.update(divmod_ms=dm,
                               divisions_per_s=batch / (dm / 1e3))
                    row.update(self.device_share(
                        lambda: S.divmod_batch(u, v)))
                    # the same division on the product kernel alone
                    fn = lambda: S.divmod_batch(u, v, impl="cuda_batched")
                    dmb = self.time_ms(fn, runs=3)
                    sh = self.device_share(fn)
                    row.update(divmod_cuda_batched_ms=dmb,
                               divmod_cuda_batched_device_ms=sh["device_ms"],
                               divmod_cuda_batched_busy_share=sh[
                                   "device_busy_share"])
                    K.mul_batch(q, v, m)
                    row["mul_batch_cluster"] = self.D.last_cluster[
                        "mul_batch"]
                    row["mul_batch_rate_per_sm"] = self.rate(
                        batch * m * (m + 1) // 2,
                        row["mul_batch_device_ms"])
                    if first:
                        agg["mul_batch"]["cluster"] = row["mul_batch_cluster"]
                rows.append(row)
                log(json.dumps(row))
        for name in ("powdiff", "update"):
            agg[name]["full_window"] = {
                f"2^{b.bit_length() - 1}": d[name]
                for b, d in self.step_full.items()}
        agg["correct"]["cells"] = {f"2^{b.bit_length() - 1}": d
                                   for b, d in self.correct_cells.items()}
        self.report["timing"] = rows
        self.agg = agg

    def timing_prologue(self):
        """prologue_kernel at both benchmark cells' shapes: CUDA-event
        time of back-to-back launches against its bytes bound (u and v
        read, uw, vw, vl and w written, the scalars and flags), and the
        ATen set-up's time at the same shape."""
        F, S, torch = self.F, self.S, self.torch
        cells = {}
        for bits, batch in PROLOGUE_CELLS:
            m = bits // 16
            W = m + S.PAD
            u, v = self.cell_operands(m, batch, bits + 1)
            fn = lambda: F.prologue_cuda(v, u=u)
            ms = self.burst_ms(fn, n=10)
            plain_ms = self.time_ms(lambda: S.prologue_plain(v, u=u), runs=3)
            nbytes = batch * ((2 * m + 4 * W) * 4 + 5 * 4 + 3)
            bound_ms = self.bound(0, nbytes)[0]
            cells[f"2^{bits.bit_length() - 1}"] = dict(
                shape=f"2^{bits.bit_length() - 1} bits x {batch}", ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bytes=nbytes,
                roofline=bound_ms / ms)
            pt = self.report["ptxas"].get("prologue_kernel", {})
            log(f"prologue 2^{bits.bit_length() - 1} bits x {batch}: "
                f"{ms:.4f} ms (bound {bound_ms:.4f} ms by bytes, "
                f"{100 * bound_ms / ms:.1f}%), ATen set-up "
                f"{plain_ms:.3f} ms, ptxas {pt}")
            del u, v, fn
            torch.cuda.empty_cache()
        c = cells["2^15"]
        self.agg["prologue"] = dict(
            event_ms=c["ms"], device_ms=None, plain_ms=c["plain_ms"],
            products=0, bytes=c["bytes"], launches=1,
            ms_source="cuda_events", shape=c["shape"], cells=cells)
        self.report["prologue"] = dict(card=card_line(), cells=cells)

    def step_work(self, st):
        """(products, bytes) of one powdiff and one update launch on these
        states (`costmodel.powdiff_work`/`update_work` over the lanes'
        significant limbs of vp = shift(v, -s), wq and x in the window),
        and the share of update's product columns its cut keeps."""
        A, win = self.A, st["win"]
        batch, fw = st["v"].shape
        pv = A.prec(A.shift(st["v"], -st["s"])[:, :win]).tolist()
        pw = A.prec(st["w"][:, :win]).tolist()
        px = A.prec(st["x"][:, :win]).tolist()
        off = (st["h"] - 2 * st["m"]).tolist()
        act = st["active"].tolist()
        up = self.CM.update_work(batch, fw, win, pw, px, off, act)
        return (self.CM.powdiff_work(batch, fw, win, pv, pw), up[:2],
                up[2])

    def correct_work(self, c):
        """(products, bytes) of one correct launch on these inputs
        (`costmodel.correct_work`): the lanes with v != 0, with q =
        floor(u * si / B^h) cut to W (the kernel's q, before the
        correction)."""
        ints = self.bi.batch_to_ints
        batch, W = c["u"].shape
        lanes = []
        for u, v, si, h in zip(ints(c["u"]), ints(c["v"]), ints(c["si"]),
                               c["h"].tolist()):
            if v:
                q = ((u * si) >> (16 * h)) % (1 << (16 * W))
                lanes.append((prec_of(u), prec_of(si), prec_of(q),
                              prec_of(v), h))
        return self.CM.correct_work(batch, W, lanes)

    def rate(self, products, device_ms):
        """Limb products per second per SM over a kernel's device time."""
        if not device_ms:
            return None
        return products / (device_ms / 1e3) / self.sms

    def burst_ms(self, fn, n=20):
        """Time of one call from CUDA events around n back-to-back calls
        after a warm-up: the device time of a kernel whose run is longer
        than its wrapper's host cost."""
        torch = self.torch
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    def profiler_warmup(self):
        """A short spin kernel (torch.cuda._sleep, `spin_kernel`) first in
        every profile: the profiler may drop a session's first device
        event, and this one is never counted."""
        self.torch.cuda._sleep(10000)
        self.torch.cuda.synchronize()

    def device_us(self, calls):
        """Device time (us) of each port kernel the calls launch, in
        launch order (torch.profiler); None where the profiler reports
        a different number of kernels than there are calls."""
        from torch.profiler import ProfilerActivity, profile
        for _ in range(2):                  # once more if events were lost
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                self.profiler_warmup()
                for fn in calls:
                    fn()
                self.torch.cuda.synchronize()
            evs = [e for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and e.name.split("(")[0].endswith("_kernel")
                   and e.name.split("(")[0][:-len("_kernel")] in KERNELS]
            evs.sort(key=lambda e: e.time_range.start)
            if len(evs) == len(calls):
                return [e.time_range.elapsed_us() for e in evs]
            log(f"profiler saw {len(evs)} kernels for {len(calls)} calls: "
                f"{[e.name.split('(')[0] for e in evs]}")
        return None

    def device_share(self, fn):
        """Device time of one call by kernel name (torch.profiler), and
        the device's busy share of that same profiled call's wall time
        (host clock from the call to its synchronize; the profiler's
        host cost makes the share a lower bound, never above 1).  None
        where the profiler reports no device time."""
        from torch.profiler import ProfilerActivity, profile
        per = {}
        for _ in range(2):                  # once more if events were lost
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                self.profiler_warmup()
                t0 = time.perf_counter()
                fn()
                self.torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total", 0) or 0
                if (us > 0
                        and str(getattr(e, "device_type", "")).endswith("CUDA")
                        and "spin_kernel" not in e.key):
                    name = e.key.split("(")[0]
                    per[name] = dict(us=us, count=e.count)
            if per:
                break
        total = sum(d["us"] for d in per.values()) / 1e3
        ours = {k: per[k] for k in per if k.endswith("_kernel")
                and k.split("_kernel")[0] in KERNELS}
        return dict(device_ms=total if per else None,
                    device_busy_share=total / wall_ms if per else None,
                    profiled_wall_ms=wall_ms,
                    device_by_kernel=ours, device_other_ms=(
                        total - sum(d["us"] for d in ours.values()) / 1e3)
                    if per else None)

    # -- phase 3b: the Barrett kernel against its plain version -------------

    def barrett_lanes(self, m, seed):
        """16 Barrett operands at W = barrett_width(m) with mu =
        shinv_h(v) + lambda computed on the host: lanes built to take
        `over` (lambda = 1, x = k v - 1 near B^(2m)) and `under`
        (lambda = 0, x = k v), x = B^(2m) - 1, x < v, the edge moduli
        (1, B^k, all-0xFFFF, one limb), and an arbitrary and a zero mu
        on the last two lanes."""
        MA, B = self.MA, 1 << 16
        rnd = random.Random(seed)
        W, h = MA.barrett_width(m), MA.barrett_h(m)
        top = [rnd.getrandbits(16 * m) | 1 << (16 * m - 1) for _ in range(9)]
        vs = top + [1, B ** (m - 1), B ** m - 1, 0xFFFF, 3, top[0], top[1]]
        xs, lams = [], []
        for i, v in enumerate(vs):
            k = (B ** (2 * m) - 1) // v
            xs.append([k * v - 1, k * v, rnd.getrandbits(32 * m)][i % 3])
            lams.append(1 if i % 3 == 0 else i % 2)
        xs[6], xs[7] = B ** (2 * m) - 1, vs[7] - 1
        mus = [B ** h // v + lam for v, lam in zip(vs, lams)]
        mus[-2], mus[-1] = rnd.getrandbits(16 * W), 0
        return (self.tensor(xs, 2 * m), self.tensor(mus, W),
                self.tensor(vs, m), h, xs, vs)

    def count_branches(self, over, under):
        self.branches["over"] += int(over.sum())
        self.branches["under"] += int(under.sum())
        self.branches["lanes"] += over.numel()

    @contextmanager
    def checking_modarith(self):
        """Route every launch of the modular path (the precompute's
        Refine steps, the products, the Barrett reductions) through
        kernel AND plain version on the same inputs; count the Barrett
        branches in the plain version."""
        F, K = self.F, self.K
        orig = K.fused_step, K.mul_batch, K.fused_barrett

        def step(v, w, *, h, m, l, s, active, g, win, impl=None):
            fused_only(impl)
            hpd, lpd = h - m, l - g
            sk, xk = F.powdiff_cuda(v, w, hpd, lpd, s, win=win)
            self.compare("powdiff", (sk, xk),
                         F.powdiff_reference(v, w, hpd, lpd, s, win=win))
            out = F.update_cuda(w, xk, sk, h, m, active, win=win)
            self.compare("update", (out,), (F.update_reference(
                w, xk, sk, h, m, active, win=win),))
            return out

        def mul_batch(u, v, out_width, impl=None):
            fused_only(impl)
            got = self.bigmul.mul_batch_cuda(u, v, out_width)
            self.compare("mul_batch", (got,),
                         (K.mul_plain(u, v, out_width),))
            return got

        def barrett(x, mu, v, *, h, impl=None):
            fused_only(impl)
            got = F.barrett_cuda(x, mu, v, h=h)
            r, over, under = F.barrett_branches(x, mu, v, h=h)
            self.compare("barrett", (got,), (r,))
            self.count_branches(over, under)
            return got

        K.fused_step, K.mul_batch, K.fused_barrett = step, mul_batch, barrett
        try:
            yield
        finally:
            K.fused_step, K.mul_batch, K.fused_barrett = orig

    def check_barrett(self):
        """Synthetic adversarial operands at 2^15- and 2^17-bit moduli
        (the largest, where a product or a q window past 2W would show),
        a shared mu and v read with row stride 0, then the real states of
        reduce, modmul, the precompute and a short modexp at every
        modulus size."""
        F, MA = self.F, self.MA
        self.branches = {"over": 0, "under": 0, "lanes": 0}
        for bits in (2 ** 15, 2 ** 17):
            m = bits // 16
            x, mu, v, h, xs, vs = self.barrett_lanes(m, bits)
            got = F.barrett_cuda(x, mu, v, h=h)
            r, over, under = F.barrett_branches(x, mu, v, h=h)
            self.compare("barrett", (got,), (r,))
            self.count_branches(over, under)
            for i, rr in enumerate(self.bi.batch_to_ints(got[:-2])):
                if rr != xs[i] % vs[i]:
                    raise AssertionError(f"barrett lane {i} inexact")
            got = F.barrett_cuda(x, mu[0], v[0], h=h)
            self.compare("barrett", (got,),
                         (F.barrett_reference(x, mu[0], v[0], h=h),))
            if self.bi.batch_to_ints(got) != [xx % vs[0] for xx in xs]:
                raise AssertionError("barrett with a shared context inexact")
            log(f"barrett synthetic 2^{bits.bit_length() - 1}-bit moduli: "
                f"exact, branches so far {self.branches}")
        for bits, batch in MODULI:
            m = bits // 16
            L = mod_operands(m, batch, bits + 3)
            x, a = self.tensor(L["x"], 2 * m), self.tensor(L["a"], m)
            with self.checking_modarith():
                ctx = MA.barrett_precompute(self.tensor([L["v"]], m)[0])
                MA.reduce_shared(ctx, x)
                MA.modmul_shared(ctx, a, self.tensor(L["b"], m))
                if bits == MODULI[0][0]:
                    MA.modexp_shared(ctx, a[:16], self.tensor(
                        [y % (1 << 16) for y in L["e"][:16]], 1))
                    MA.reduce_batch(x[:64], self.tensor(L["vs"][:64], m))
            log(f"modular path 2^{bits.bit_length() - 1}-bit modulus: "
                f"kernels == plain on every launch")
        log(f"barrett branches in the plain version: {self.branches}")
        if not (self.branches["over"] and self.branches["under"]):
            raise AssertionError("a Barrett correction branch never ran")
        self.report["barrett_branches"] = dict(self.branches)
        self.report["checked"] = dict(self.checked)
        log(f"kernel-vs-plain comparisons: {self.checked}, max abs err "
            f"{self.err}")

    # -- phase 5: the modular-arithmetic path --------------------------------

    def launched(self, fn):
        """(fn(), kernel launches it made)."""
        before = sum(self.build.launch_counts().values())
        out = fn()
        self.torch.cuda.synchronize()
        return out, sum(self.build.launch_counts().values()) - before

    def expect(self, what, got, want):
        if got != want:
            raise AssertionError(f"{what}: {got}, expected {want}")

    def modarith_path(self):
        MA, CM, B = self.MA, self.CM, 1 << 16
        ints = self.bi.batch_to_ints
        self.mod_inputs = {}
        for bits, batch in MODULI:
            m = bits // 16
            tag = f"2^{bits.bit_length() - 1}-bit modulus"
            L = mod_operands(m, batch, bits)
            vt = self.tensor([L["v"]], m)[0]
            ctx, pre = self.launched(lambda: MA.barrett_precompute(vt))
            self.expect(f"{tag} precompute launches", pre,
                        CM.precompute_launches(m) + CM.prologue_launches())
            mu = self.bi.to_int(self.bi.limbs_to_numpy(ctx.mu))
            if mu - B ** MA.barrett_h(m) // L["v"] not in (0, 1):
                raise AssertionError(f"{tag}: mu is not shinv + lambda")
            x, a, b = (self.tensor(L["x"], 2 * m), self.tensor(L["a"], m),
                       self.tensor(L["b"], m))
            r, n = self.launched(lambda: MA.reduce_shared(ctx, x))
            self.expect(f"{tag} reduce launches", n, CM.barrett_launches())
            if ints(r) != [xx % L["v"] for xx in L["x"]]:
                raise AssertionError(f"{tag}: reduce_shared inexact")
            p, n = self.launched(lambda: MA.modmul_shared(ctx, a, b))
            self.expect(f"{tag} modmul launches", n, CM.modmul_launches())
            if ints(p) != [aa * bb % L["v"] for aa, bb in zip(L["a"],
                                                               L["b"])]:
                raise AssertionError(f"{tag}: modmul_shared inexact")
            log(f"{tag}: precompute {pre} launches, "
                f"reduce_shared and modmul_shared on {batch} lanes "
                f"(1 and 2 launches), every lane exact")
            self.mod_inputs[bits] = dict(L=L, vt=vt, ctx=ctx, x=x, a=a, b=b)
            if bits != MODULI[0][0]:
                continue
            vl = self.tensor(L["vs"][:64], m)
            r, n = self.launched(lambda: MA.reduce_batch(x[:64], vl))
            self.expect(f"{tag} reduce_batch launches", n,
                        CM.precompute_launches(m) + CM.prologue_launches()
                        + CM.barrett_launches())
            if ints(r) != [xx % vv for xx, vv in zip(L["x"], L["vs"][:64])]:
                raise AssertionError(f"{tag}: reduce_batch inexact")
            p, n = self.launched(lambda: MA.modmul_batch(a[:64], b[:64], vl))
            self.expect(f"{tag} modmul_batch launches", n,
                        CM.precompute_launches(m) + CM.prologue_launches()
                        + CM.modmul_launches())
            if ints(p) != [aa * bb % vv for aa, bb, vv in zip(
                    L["a"], L["b"], L["vs"][:64])]:
                raise AssertionError(f"{tag}: modmul_batch inexact")
            log(f"{tag}: reduce_batch and modmul_batch with 64 per-lane "
                f"moduli, every lane exact")
            et = self.tensor(L["e"][:64], E_LIMBS)
            t0 = time.perf_counter()
            y, n = self.launched(lambda: MA.modexp_shared(ctx, a[:64], et))
            dt = time.perf_counter() - t0
            self.expect(f"{tag} modexp launches", n,
                        CM.modexp_launches(16 * E_LIMBS))
            if ints(y) != pow_all(zip(L["a"][:64], L["e"][:64],
                                      [L["v"]] * 64)):
                raise AssertionError(f"{tag}: modexp_shared inexact")
            log(f"{tag}: modexp_shared on 64 lanes, {16 * E_LIMBS}-bit "
                f"exponents: {n} launches ({dt:.2f} s), every lane exact")
        self.modulus_2p18()
        self.mod_service()

    def modulus_2p18(self):
        """A 2^18-bit modulus under cuda_fused: the precompute's step
        kernels stage its full W = 32778 window; reduce_shared and
        modmul_shared on MOD18_LANES lanes, every lane exact."""
        MA, CM, B = self.MA, self.CM, 1 << 16
        ints = self.bi.batch_to_ints
        m, n = M18, MOD18_LANES
        tag = "2^18-bit modulus"
        L = mod_operands(m, 8, 2 ** 18 + 3)
        vt = self.tensor([L["v"]], m)[0]
        ctx, k = self.launched(lambda: MA.barrett_precompute(vt))
        self.expect(f"{tag} precompute launches", k,
                    CM.precompute_launches(m) + CM.prologue_launches())
        pre = k
        mu = self.bi.to_int(self.bi.limbs_to_numpy(ctx.mu))
        if mu - B ** MA.barrett_h(m) // L["v"] not in (0, 1):
            raise AssertionError(f"{tag}: mu is not shinv + lambda")
        x, a, b = (self.tensor(L["x"][:n], 2 * m), self.tensor(L["a"][:n], m),
                   self.tensor(L["b"][:n], m))
        r, k = self.launched(lambda: MA.reduce_shared(ctx, x))
        self.expect(f"{tag} reduce launches", k, CM.barrett_launches())
        if ints(r) != [xx % L["v"] for xx in L["x"][:n]]:
            raise AssertionError(f"{tag}: reduce_shared inexact")
        p, k = self.launched(lambda: MA.modmul_shared(ctx, a, b))
        self.expect(f"{tag} modmul launches", k, CM.modmul_launches())
        if ints(p) != [aa * bb % L["v"] for aa, bb in zip(L["a"][:n],
                                                          L["b"][:n])]:
            raise AssertionError(f"{tag}: modmul_shared inexact")
        log(f"{tag}: precompute {pre} launches, "
            f"reduce_shared and modmul_shared on {n} lanes (1 and 2 "
            f"launches), every lane exact")
        self.mod_inputs[2 ** 18] = dict(L=L, vt=vt, ctx=ctx, x=x, a=a, b=b)

    def mod_service(self):
        m = 2048
        svc = self.ModService(m_limbs=m, e_limbs=E_LIMBS,
                              batch_buckets=(16, 64), device=self.dev)
        L1, L2 = mod_operands(m, 100, 71), mod_operands(m, 100, 72)
        v1, v2 = L1["v"], L2["v"]
        ok = [svc.reduce(L1["x"][:10], v1) == [x % v1 for x in L1["x"][:10]],
              svc.modmul(L2["a"], L2["b"], v2) == [        # 100 = 64 + 36
                  a * b % v2 for a, b in zip(L2["a"], L2["b"])],
              svc.reduce(L2["x"][:64], v2) == [x % v2 for x in L2["x"][:64]],
              svc.modexp(L1["a"][:8], L1["e"][:8], v1) == pow_all(
                  zip(L1["a"][:8], L1["e"][:8], [v1] * 8)),
              svc.modmul(L1["a"][:3], L1["b"][:3], v1) == [
                  a * b % v1 for a, b in zip(L1["a"][:3], L1["b"][:3])]]
        if not all(ok):
            raise AssertionError(f"ModArithService answers wrong: {ok}")
        st = svc.stats()
        c = st["ctx_cache"]
        log(f"ModArithService m_limbs={m}: {st['requests']} requests, "
            f"{st['rows_true']} rows in {st['rows_padded']} padded, exact; "
            f"context cache hits {c['hits']}, misses {c['misses']}")
        self.expect("context cache (hits, misses)",
                    (c["hits"], c["misses"]), (3, 2))
        self.report["mod_service"] = st

    # -- phase 6b: timing of the modular path --------------------------------

    def barrett_work(self, L, ctx, m, lanes):
        """(limb products, bytes) one reduce_shared launch needs
        (`costmodel.barrett_work`): x * mu over the nonzero widths of x
        and mu, q * v truncated to W over the nonzero widths of q and v,
        q = floor(x * mu / B^h) cut to W."""
        MA, B = self.MA, 1 << 16
        W, h = MA.barrett_width(m), MA.barrett_h(m)
        mu = self.bi.to_int(self.bi.limbs_to_numpy(ctx.mu))
        rows = [(prec_of(xx), prec_of((xx * mu >> 16 * h) % B ** W))
                for xx in L["x"][:lanes]]
        return self.CM.barrett_work(lanes, m, rows, nmu=prec_of(mu),
                                    nv=prec_of(L["v"]))

    def timing_modarith(self):
        """Per modulus size: one Barrett launch's device time (first, before
        any long profile) against its bound, and the plain version at the
        2^15-bit modulus; then precompute, reduce_shared, modmul_shared and
        modexp_shared (64 lanes, 256-bit exponents) timed with CUDA events
        around the call, with the device's busy share of each
        (torch.profiler)."""
        F, MA = self.F, self.MA
        rows = []
        for bits, batch in MODULI:
            m = bits // 16
            mi = self.mod_inputs[bits]
            ctx, x = mi["ctx"], mi["x"]
            h = MA.barrett_h(m)
            a, b = mi["a"], mi["b"]
            # the reduce launch, the one of a 64-lane modexp, and
            # modmul's a*b product (m x m -> 2m limbs)
            kern = lambda: F.barrett_cuda(x, ctx.mu, ctx.v, h=h)
            kern64 = lambda: F.barrett_cuda(x[:64], ctx.mu, ctx.v, h=h)
            prod = lambda: self.bigmul.mul_batch_cuda(a, b, 2 * m)
            dev = self.device_us([kern, kern64, prod])
            dms = [d / 1e3 for d in dev] if dev else [None] * 3
            work = self.barrett_work(mi["L"], ctx, m, batch)
            work64 = self.barrett_work(mi["L"], ctx, m, 64)
            work_ab = self.CM.mul_work(batch, m, m, 2 * m)
            row = dict(modulus_bits=bits, lanes=batch,
                       barrett_ms=self.time_ms(kern),
                       barrett_device_ms=dms[0] if dev else None)
            row["barrett_cluster"] = self.D.last_cluster["barrett"]
            row["barrett_bound_ms"], row["barrett_bound_by"] = \
                self.bound(*work)
            row["barrett_products"], row["barrett_bytes"] = work
            # CUDA events around 20 back-to-back launches: the device
            # time where the profiler lost a kernel's events
            bursts = [self.burst_ms(fn) for fn in (kern, kern64, prod)]
            dms = [d if d is not None else b for d, b in zip(dms, bursts)]
            row["burst_ms"] = dict(zip(("barrett", "barrett_64", "mul_ab"),
                                       bursts))
            row["barrett_rate_per_sm"] = self.rate(work[0], dms[0])
            row["barrett_64_ms"] = self.time_ms(kern64)
            row["barrett_64_device_ms"] = dms[1] if dev else None
            row["barrett_64_cluster"] = self.D.last_cluster["barrett"]
            row["barrett_64_bound_ms"] = self.bound(*work64)[0]
            row["barrett_64_rate_per_sm"] = self.rate(work64[0], dms[1])
            row["mul_ab_ms"] = self.time_ms(prod)
            row["mul_ab_device_ms"] = dms[2] if dev else None
            row["mul_ab_cluster"] = self.D.last_cluster["mul_batch"]
            row["mul_ab_bound_ms"] = self.bound(*work_ab)[0]
            row["mul_ab_rate_per_sm"] = self.rate(work_ab[0], dms[2])
            if bits == MODULI[0][0]:
                row["barrett_plain_ms"] = self.time_ms(
                    lambda: F.barrett_reference(x, ctx.mu, ctx.v, h=h))
                self.agg["barrett"] = dict(
                    event_ms=row["barrett_ms"], device_ms=dms[0],
                    ms_source="profiler" if dev else
                    "cuda_events over 20 back-to-back launches",
                    plain_ms=row["barrett_plain_ms"], products=work[0],
                    bytes=work[1], shape=f"one reduce_shared, 2^15-bit "
                    f"modulus, {batch} lanes", cluster=row["barrett_cluster"])
            rows.append(row)
        for row, (bits, batch) in zip(rows, MODULI):
            mi = self.mod_inputs[bits]
            L, ctx, x, a, b = (mi[k] for k in ("L", "ctx", "x", "a", "b"))
            et = self.tensor(L["e"][:64], E_LIMBS)
            calls = {
                "precompute": lambda: MA.barrett_precompute(mi["vt"]),
                "reduce": lambda: MA.reduce_shared(ctx, x),
                "modmul": lambda: MA.modmul_shared(ctx, a, b),
                "modexp": lambda: MA.modexp_shared(ctx, a[:64], et)}
            for name, fn in calls.items():
                runs = 3 if name == "modexp" and bits != MODULI[0][0] else 5
                ms = self.time_ms(fn, runs=runs)
                share = self.device_share(fn)
                row[f"{name}_ms"] = ms
                row[f"{name}_device_ms"] = share["device_ms"]
                row[f"{name}_busy_share"] = share["device_busy_share"]
            row["reductions_per_s"] = batch / (row["reduce_ms"] / 1e3)
            row["modmuls_per_s"] = batch / (row["modmul_ms"] / 1e3)
            row["modexp_lanes"] = 64
            row["exponentiations_per_s"] = 64 / (row["modexp_ms"] / 1e3)
            if bits != MODULI[0][0]:          # exactness at 2^15: phase 5
                got = self.bi.batch_to_ints(calls["modexp"]()[:4])
                if got != pow_all(zip(L["a"][:4], L["e"][:4],
                                      [L["v"]] * 4)):
                    raise AssertionError(f"modexp inexact at {bits} bits")
            log(json.dumps(row))
        # the precompute at a 2^18-bit modulus, which its step kernels'
        # staging now holds
        fn = lambda: MA.barrett_precompute(self.mod_inputs[2 ** 18]["vt"])
        share = self.device_share(fn)
        row = dict(modulus_bits=2 ** 18, lanes=MOD18_LANES,
                   precompute_ms=self.time_ms(fn, runs=3),
                   precompute_device_ms=share["device_ms"],
                   precompute_busy_share=share["device_busy_share"])
        rows.append(row)
        log(json.dumps(row))
        self.report["timing_modarith"] = rows

    # -- phase 6b: graph against eager ---------------------------------------

    @staticmethod
    def outs(o):
        """A tensor or a tuple of tensors (a BarrettContext) as a tuple."""
        return (o,) if hasattr(o, "shape") else tuple(o)

    def built(self, what, make):
        """make() builds a bucket executable: it, and its build's cost
        (the warm-up, the capture and the instantiation, in seconds, and
        the growth of the reserved device memory over the capture)."""
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe = make()
        dt = time.perf_counter() - t0
        if exe.graph is None:
            raise AssertionError(f"{what}: no graph on the card")
        self.expect(f"{what}: graph launches vs its static profile",
                    sum(exe.launches.values()),
                    exe.static["kernel_launches"])
        return exe, dict(build_seconds=dt,
                         capture_seconds=exe.capture_seconds,
                         instantiate_seconds=exe.instantiate_seconds,
                         pool_bytes=exe.memory_bytes,
                         glue_ops=exe.static["glue_ops"])

    def graph_vs_eager(self, what, exe, info, args, eager, model,
                       plain=None, runs=5):
        """The executable's call (copy in, replay, copy out) against the
        eager call, in turns (eager, graph, graph, eager; each a median
        of `runs` CUDA-event timings after a warm-up), with each one's
        device busy share (torch.profiler); the replay equal to eager
        and plain bit for bit; 3 replays counting 3x the model's
        launches."""
        torch = self.torch
        graph = lambda: exe(*args)
        ms = {"eager": [], "graph": []}
        for kind in ("eager", "graph", "graph", "eager"):
            ms[kind].append(self.time_ms(graph if kind == "graph" else eager,
                                         runs=runs))
        got = self.outs(graph())
        refs = [("eager", self.outs(eager()))]
        if plain is not None:
            refs.append(("plain", self.outs(plain())))
        torch.cuda.synchronize()
        for name, ref in refs:
            if len(ref) != len(got) or not all(
                    torch.equal(g, r) for g, r in zip(got, ref)):
                raise AssertionError(f"{what}: the replay differs from "
                                     f"{name}")
        self.build.reset_launch_counts()
        for _ in range(3):
            graph()
        torch.cuda.synchronize()
        self.expect(f"{what}: launches of 3 replays",
                    self.build.launch_counts(),
                    {k: 3 * n for k, n in exe.launches.items()})
        self.expect(f"{what}: launches per replay",
                    sum(exe.launches.values()), model)
        se, sg = self.device_share(eager), self.device_share(graph)
        med = {k: statistics.median(v) for k, v in ms.items()}
        row = dict(cell=what, eager_ms=ms["eager"], graph_ms=ms["graph"],
                   speedup=med["eager"] / med["graph"],
                   eager_device_ms=se["device_ms"],
                   eager_busy_share=se["device_busy_share"],
                   graph_device_ms=sg["device_ms"],
                   graph_busy_share=sg["device_busy_share"],
                   launches_per_call=model,
                   checked_against=[n for n, _ in refs], **info)
        if se["device_ms"]:
            # the replay runs the eager call's device work
            row["graph_busy_share_of_eager_device"] = (se["device_ms"]
                                                       / med["graph"])
        log(json.dumps(row))
        return row

    def split_call(self, what, exe, pack, unpack, call):
        """One service chunk split into its steps, each timed on the host
        clock up to a synchronize: pack (Python ints to host limbs),
        copy-in, replay, copy-out (to host numpy), unpack (to Python
        ints), beside the whole service call."""
        torch, bi = self.torch, self.bi
        t = {}
        t0 = time.perf_counter()
        args = pack()
        t["pack_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for dst, src in zip(exe.inputs, args):
            dst.copy_(src)
        torch.cuda.synchronize()
        t["copy_in_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        exe.graph.replay()
        torch.cuda.synchronize()
        t["replay_ms"] = (time.perf_counter() - t0) * 1e3
        self.build.count_all(exe.launches)
        t0 = time.perf_counter()
        outs = [bi.limbs_to_numpy(o) for o in exe.outputs]
        t["copy_out_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        unpack(outs)
        t["unpack_ms"] = (time.perf_counter() - t0) * 1e3
        call()                                       # warm
        t0 = time.perf_counter()
        call()
        t["service_call_ms"] = (time.perf_counter() - t0) * 1e3
        row = dict(cell=what, **t)
        log(json.dumps(row))
        return row

    def graphs(self):
        """Phase 6b: every service's bucket executables against the eager
        calls, at the division cells (cuda_fused at 2^15..2^18 bits,
        cuda_batched and cuda_pairs at 2^15 x 256 and 2^18 x 32) and the
        modular ones (the precompute, reduce and modmul at 2^15/2^16/2^17
        bits, modexp on 64 lanes with 256-bit exponents), then a modexp
        with a full 2^15-bit exponent (the service's default e_limbs =
        m_limbs: the whole ladder in one graph); the service calls split
        into their steps; the measured-vs-model table of every service,
        each row matching on the card."""
        S, MA, CM, bi = self.S, self.MA, self.CM, self.bi
        from repro_torch.obs import report as R
        from repro_torch.serving import batching as BT
        rows, splits, services = [], [], []
        plain = {}
        cells = [(bits, batch, "cuda_fused") for bits, batch in PRECISIONS]
        cells += [(bits, batch, impl) for impl in ("cuda_batched",
                                                   "cuda_pairs")
                  for bits, batch in (PRECISIONS[0], PRECISIONS[-1])]
        for bits, batch, impl in cells:
            m = bits // 16
            u, v, _ = self.main_inputs[bits]
            what = f"divmod 2^{bits.bit_length() - 1} x {batch}, {impl}"
            svc = self.Service(m_limbs=m, batch_buckets=(batch,),
                               device=self.dev, impl=impl)
            exe, info = self.built(what, lambda: svc._fn(batch))
            if bits not in plain:
                plain[bits] = S.divmod_batch(u, v, impl="blocked")
            rows.append(self.graph_vs_eager(
                what, exe, info, (u, v),
                lambda: S.divmod_batch(u, v, impl=impl),
                CM.divmod_launches(m, impl) + CM.prologue_launches(impl),
                plain=lambda: plain[bits],
                runs=5 if impl == "cuda_fused" else 3))
            services.append(svc)
            if impl != "cuda_fused":
                continue
            us, vs = operands(m, batch, bits + 1)
            pad = lambda xs, fill: bi.limbs_from_numpy(bi.batch_from_ints(
                BT.pad_ints(xs, batch, fill), m), "cpu")
            splits.append(self.split_call(
                what, exe, lambda: (pad(us, 0), pad(vs, 1)),
                lambda o: [bi.batch_to_ints(a) for a in o],
                lambda: svc.divide(us, vs)))
        plain.clear()
        for bits, batch in MODULI:
            m = bits // 16
            mi = self.mod_inputs[bits]
            L, ctx, x, a, b = (mi[k] for k in ("L", "ctx", "x", "a", "b"))
            et = self.tensor(L["e"][:64], E_LIMBS)
            tag = f"2^{bits.bit_length() - 1}-bit modulus"
            svc = self.ModService(m_limbs=m, e_limbs=E_LIMBS,
                                  batch_buckets=sorted({64, batch}),
                                  device=self.dev)
            first = bits == MODULI[0][0]
            cases = (
                ("precompute", svc._precompute_fn, (mi["vt"],),
                 lambda impl=None: MA.barrett_precompute(mi["vt"], impl),
                 CM.precompute_launches(m) + CM.prologue_launches(), batch),
                ("reduce", lambda: svc._fn("reduce", batch), (*ctx, x),
                 lambda impl=None: MA.reduce_shared(ctx, x, impl),
                 CM.barrett_launches(), batch),
                ("modmul", lambda: svc._fn("modmul", batch), (*ctx, a, b),
                 lambda impl=None: MA.modmul_shared(ctx, a, b, impl),
                 CM.modmul_launches(), batch),
                ("modexp", lambda: svc._fn("modexp", 64),
                 (*ctx, a[:64], et),
                 lambda impl=None: MA.modexp_shared(ctx, a[:64], et,
                                                    impl=impl),
                 CM.modexp_launches(16 * E_LIMBS), 64))
            for op, make, args, eager, model, lanes in cases:
                what = f"{op}, {tag}, {lanes} lanes"
                exe, info = self.built(what, make)
                long = op == "modexp" and not first
                rows.append(self.graph_vs_eager(
                    what, exe, info, args, eager, model,
                    plain=None if long else (lambda e=eager: e("blocked")),
                    runs=3 if long else 5))
                if not first or op == "precompute":
                    continue
                cols = {"reduce": (L["x"],), "modmul": (L["a"], L["b"]),
                        "modexp": (L["a"][:64], L["e"][:64])}[op]
                widths = {"reduce": (2 * m,), "modmul": (m, m),
                          "modexp": (m, E_LIMBS)}[op]
                pack = lambda cols=cols, widths=widths, n=lanes: tuple(
                    ctx) + tuple(bi.limbs_from_numpy(bi.batch_from_ints(
                        BT.pad_ints(c, n, 0), w), "cpu")
                        for c, w in zip(cols, widths))
                splits.append(self.split_call(
                    what, exe, pack,
                    lambda o: [bi.batch_to_ints(a) for a in o],
                    lambda op=op, cols=cols: getattr(svc, op)(*cols,
                                                              L["v"])))
            services.append(svc)
        row, svc = self.full_exponent()
        rows.append(row)
        services.append(svc)
        tables = []
        for svc in services:
            snap = svc.snapshot()
            table = R.render_measured_vs_model(snap)
            log(table)
            tables.append(table)
            bad = [r for r in R.measured_vs_model(snap)
                   if not r["match"] or r["model_launches"] is None]
            if bad:
                raise AssertionError(f"measured vs model: {bad}")
        self.report["graphs"] = dict(cells=rows, splits=splits,
                                     measured_vs_model=tables)

    def full_exponent(self):
        """ModArithService's default e_limbs = m_limbs at a 2^15-bit
        modulus on 4 lanes: the whole ladder (modexp_launches(2^15)
        launches) as one graph; its build's cost, one replay against one
        eager call, equal bit for bit."""
        MA, CM = self.MA, self.CM
        m, lanes = M15, 4
        svc = self.ModService(m_limbs=m, batch_buckets=(lanes,),
                              device=self.dev)
        mi = self.mod_inputs[2 ** 15]
        ctx, a = mi["ctx"], mi["a"][:lanes]
        rnd = random.Random(2 ** 15)
        e = self.tensor([rnd.getrandbits(16 * m) for _ in range(lanes - 1)]
                        + [(1 << (16 * m)) - 1], m)
        what = f"modexp, 2^15-bit modulus, 2^15-bit exponents, {lanes} lanes"
        exe, info = self.built(what, lambda: svc._fn("modexp", lanes))
        model = CM.modexp_launches(16 * m)
        self.expect(f"{what}: launches per replay",
                    sum(exe.launches.values()), model)
        torch = self.torch
        ev = lambda: (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        (g0, g1), (e0, e1) = ev(), ev()
        g0.record()
        got = exe(*ctx, a, e)
        g1.record()
        g1.synchronize()
        e0.record()
        want = MA.modexp_shared(ctx, a, e)
        e1.record()
        e1.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: the replay differs from eager")
        row = dict(cell=what, graph_ms=[g0.elapsed_time(g1)],
                   eager_ms=[e0.elapsed_time(e1)], launches_per_call=model,
                   checked_against=["eager"], **info)
        log(json.dumps(row))
        return row, svc

    # -- phase 3c: the pair kernel against its plain version ----------------

    def limbs(self, batch, w, seed, zero_lane=False):
        """numpy-seeded (batch, w) limbs on the card: lane 0 all-0xFFFF,
        lane 1 zero with `zero_lane`, the rest random."""
        import numpy as np
        a = np.random.default_rng(seed).integers(0, 1 << 16, (batch, w),
                                                 dtype=np.uint32)
        a[0] = 0xFFFF
        if zero_lane:
            a[1] = 0
        return self.bi.limbs_from_numpy(a, self.dev)

    def check_lanes(self, u, v, got, mod):
        """The first three lanes of a product against Python ints."""
        ints = self.bi.batch_to_ints
        for x, y, z in zip(ints(u[:3]), ints(v[:3]), ints(got[:3])):
            if z != x * y % mod:
                raise AssertionError("pair product inexact")

    def check_pairs(self):
        """mul_pairs and mulmod_pairs against their plain versions on the
        card, bit for bit: the q*v products of the 2^15 x 256 and
        2^18 x 32 division cells, divmod's double-width u*shinv at
        2^18 x 32, the 2^18-bit modulus's x*mu on 4 lanes, and the close
        product at l_max on and around tile edges (lane 0 all-0xFFFF);
        three lanes of each against Python ints."""
        bm, B = self.bigmul, 1 << 16
        w18 = self.MA.barrett_width(M18)
        wd = M18 + self.S.PAD                   # divmod's working width
        cases = (("q*v, 2^15 bits x 256", 256, M15, M15, M15),
                 ("q*v, 2^18 bits x 32", 32, M18, M18, M18),
                 ("u*shinv, 2^18 bits x 32", 32, wd, wd, 2 * wd),
                 ("x*mu, 2^18-bit modulus x 4", 4, 2 * M18, w18, 2 * w18))
        for i, (what, batch, wu, wv, wo) in enumerate(cases):
            u = self.limbs(batch, wu, 10 + i, zero_lane=True)
            v = self.limbs(batch, wv, 20 + i)
            got = bm.mul_pairs(u, v, wo)
            self.compare("mul_pairs", (got,),
                         (bm.mul_pairs_reference(u, v, wo),))
            self.check_lanes(u, v, got, B ** wo)
            log(f"mul_pairs {what} ({wu} x {wv} -> {wo} limbs): exact")
        u = self.limbs(64, M15, 30, zero_lane=True)
        v = self.limbs(64, M15, 31)
        t, tc = self.K.BLOCK_T, bm.PAIRS_TC
        l_maxes = sorted({1, t - 1, t, t + 1, tc - 1, tc, tc + 1,
                          M15 - 1, M15} & set(range(1, M15 + 1)))
        for l_max in l_maxes:
            got = bm.mulmod_pairs(u, v, l_max, M15)
            self.compare("mul_pairs", (got,), (bm.mulmod_pairs_reference(
                u, v, l_max, M15),))
            self.check_lanes(u, v, got, B ** l_max)
        log(f"mulmod_pairs {M15} x {M15} limbs, l_max {l_maxes}: exact")
        self.check_pairs_carries()
        self.report["checked"] = dict(self.checked)

    def check_pairs_carries(self):
        """The pair kernel's in-launch carry chain, bit for bit against the
        plain version and Python ints: all-0xFFFF operands (every column
        tile above the first waits for its carry-in), lanes whose column
        tile 1 sits just below B^Tc after its carry-in and just above it,
        l_max at the 1,024-limb column-tile edges, batches 1 and 256, and
        one product of 2^16 x 2^16 limbs (the column-sum contract's width:
        no shared-memory cap)."""
        bm, B, tc = self.bigmul, 1 << 16, self.bigmul.PAIRS_TC
        ints = self.bi.batch_to_ints

        def pair(us, vs, wu, wv, l_max, wo, what):
            u, v = self.tensor(us, wu), self.tensor(vs, wv)
            got = bm.mulmod_pairs(u, v, l_max, wo)
            self.compare("mul_pairs", (got,), (bm.mulmod_pairs_reference(
                u, v, l_max, wo),))
            if ints(got) != [x * y % B ** min(l_max, wo)
                             for x, y in zip(us, vs)]:
                raise AssertionError(f"pair product inexact: {what}")
            log(f"mul_pairs {what} ({wu} x {wv} -> {min(l_max, wo)} "
                f"limbs): exact")

        x = B ** M18 - 1
        pair([x, x], [x, x], M18, M18, M18, M18,
             "all-0xFFFF, 16 column tiles waiting in turn")
        us, vs = bm.threshold_lanes(tc, 1, 3200, 300, 17)
        wu = max(prec_of(y) for y in us)
        for l_max in (tc - 1, tc, tc + 1, 2 * tc - 1, 2 * tc, 2 * tc + 1,
                      3200):
            pair(us, vs, wu, 300, l_max, 3300,
                 f"tile 1 just below / above B^{tc} after its carry-in, "
                 f"l_max {l_max}")
        rnd = random.Random(1)
        for batch in (1, 256):
            xs = [rnd.getrandbits(16 * M15) for _ in range(batch)]
            ys = [rnd.getrandbits(16 * M15) for _ in range(batch)]
            xs[0] = ys[0] = B ** M15 - 1
            pair(xs, ys, M15, M15, M15, M15, f"batch {batch}")
        w = bm.PAIRS_MAX_LIMBS
        pair([rnd.getrandbits(16 * w)], [B ** w - 1], w, w, 2 * w, 2 * w,
             "2^16 x 2^16 limbs, batch 1")

    # -- the serving frontend ------------------------------------------------

    def div_requests(self, m, sizes, seed):
        return [("divmod", operands(m, n, seed + i), None)
                for i, n in enumerate(sizes)]

    def mod_requests(self, m, seed):
        """reduce, modmul and modexp (256-bit exponents, edges 0, 1 and
        all ones) against a modulus v1, and a modmul against v2."""
        L1, L2 = mod_operands(m, 70, seed), mod_operands(m, 20, seed + 1)
        v1 = L1["v"]
        cols = {"reduce": lambda n: (L1["x"][:n],),
                "modmul": lambda n: (L1["a"][:n], L1["b"][:n]),
                "modexp": lambda n: (L1["a"][:n], L1["e"][:n])}
        return [(op, cols[op](n), v1) for op, n in MOD_REQUESTS] + [
            ("modmul", (L2["a"], L2["b"]), L2["v"])]

    def expected(self, op, cols, v):
        """What the frontend must answer, from Python ints."""
        if op == "divmod":
            qr = [divmod(u, d) if d else (0, u) for u, d in zip(*cols)]
            return [q for q, _ in qr], [r for _, r in qr]
        if op == "reduce":
            return [x % v for x in cols[0]]
        if op == "modmul":
            return [a * b % v for a, b in zip(*cols)]
        return pow_all((a, e, v) for a, e in zip(*cols))

    def serve(self, svc, requests, faults=None, return_exceptions=False):
        """Submit every request at once to an AsyncFrontend over svc;
        returns the answers (or, with return_exceptions, the error a
        request failed with), healthz() before the frontend stops, and
        the frontend."""
        import asyncio
        pol = self.policy.ServingPolicy(backoff_base=0.001, backoff_cap=0.004)

        async def drive():
            fe = self.frontend.AsyncFrontend(svc, policy=pol, faults=faults)
            async with fe:
                outs = await asyncio.gather(*[
                    fe.submit(op, *cols, v=v) for op, cols, v in requests],
                    return_exceptions=return_exceptions)
                health = fe.healthz()
            return [tuple(o) if op == "divmod" else o for o, (op, _, _) in
                    zip(outs, requests)], health, fe
        outs, health, fe = asyncio.run(drive())
        self.torch.cuda.synchronize()
        return outs, health, fe

    @staticmethod
    def fe_totals(fe):
        """faults, degradations, retries and drops of a frontend run."""
        m = fe.metrics
        tot = lambda metric: int(sum(s.value for s in metric.series()))
        return dict(faults=tot(m.faults), degraded=tot(m.degraded),
                    retries=tot(m.retries), dropped=fe.dropped_requests())

    def frontend_path(self):
        """AsyncFrontend, impl cuda_fused, over the division service at
        2^15 and 2^18 bits and ModArithService at a 2^15-bit modulus:
        every request of a run submitted at once (coalesced, one split
        across buckets), every answer against Python; no fault, retry,
        degradation or drop."""
        self.frontend_answers = {}
        runs = (("divmod 2^15", self.Service(
                    m_limbs=M15, batch_buckets=(16, 64), device=self.dev),
                 self.div_requests(M15, DIV_REQUESTS, 150)),
                ("divmod 2^18", self.Service(
                    m_limbs=M18, batch_buckets=(8, 32), device=self.dev),
                 self.div_requests(M18, (12, 30), 180)),
                ("modarith 2^15", self.ModService(
                    m_limbs=M15, e_limbs=E_LIMBS, batch_buckets=(16, 64),
                    device=self.dev), self.mod_requests(M15, 151)))
        for what, svc, reqs in runs:
            t0 = time.perf_counter()
            outs, health, fe = self.serve(svc, reqs)
            dt = time.perf_counter() - t0
            for (op, cols, v), got in zip(reqs, outs):
                if got != self.expected(op, cols, v):
                    raise AssertionError(f"frontend {what}: {op} wrong")
            self.expect(f"frontend {what} faults", self.fe_totals(fe),
                        dict(faults=0, degraded=0, retries=0, dropped=0))
            self.expect(f"frontend {what} health",
                        (health["status"], health["quarantine"]),
                        ("ok", []))
            self.frontend_answers[what] = outs
            st = svc.stats()
            log(f"frontend {what}: {len(reqs)} requests, "
                f"{st['rows_true']} rows in {st['rows_padded']} padded, "
                f"{dt:.2f} s, every answer exact, no fault")
            self.report.setdefault("frontend", {})[what] = dict(
                seconds=dt, stats=st, health=health)

    def launched_by(self, fn):
        """(fn(), the kernel launches it made by kernel)."""
        before = self.build.launch_counts()
        out = fn()
        self.torch.cuda.synchronize()
        after = self.build.launch_counts()
        return out, {k: n - before.get(k, 0) for k, n in after.items()
                     if n != before.get(k, 0)}

    def pairs_path(self):
        """The services with impl cuda_pairs: divmod at 2^15 and 2^18
        bits, reduce, modmul and a 16-bit-exponent modexp at a 2^15-bit
        modulus, and 4 reductions at a 2^18-bit modulus, which the fused
        kernels' shared memory cannot hold; every answer exact, mul_pairs
        launched as the cost model counts for cuda_pairs, and no other
        kernel."""
        CM, impl = self.CM, "cuda_pairs"
        for m, buckets, n in ((M15, (16, 64), 40), (M18, (8,), 8)):
            svc = self.Service(m_limbs=m, batch_buckets=buckets,
                               device=self.dev, impl=impl)
            for b in buckets:               # the graphs, before the count
                svc.profile_bucket(b)
            us, vs = operands(m, n, m + 5)
            got, counts = self.launched_by(lambda: svc.divide(us, vs))
            chunks = len(svc.batcher.plan(n))
            self.expect(f"cuda_pairs divmod {m} limbs launches", counts,
                        {"mul_pairs": chunks * CM.model_launches(
                            "divmod", m, impl)})
            if got != self.expected("divmod", (us, vs), None):
                raise AssertionError(f"cuda_pairs divmod {m} limbs wrong")
            log(f"cuda_pairs divmod {m} limbs x {n}: {counts}, exact")
        mod = self.ModService(m_limbs=M15, e_limbs=1, batch_buckets=(16, 64),
                              device=self.dev, impl=impl)
        L = mod_operands(M15, 20, 2052)
        v, e16 = L["v"], [e % (1 << 16) for e in L["e"][:8]]
        mod.profile_bucket("precompute", 1)
        for op in ("reduce", "modmul", "modexp"):
            for b in (16, 64):
                mod.profile_bucket(op, b)
        calls = (("reduce", (L["x"],), CM.precompute_launches(M15, impl)
                  + CM.model_launches("reduce", M15, impl)),
                 ("modmul", (L["a"], L["b"]),
                  CM.model_launches("modmul", M15, impl)),
                 ("modexp", (L["a"][:8], e16),
                  CM.model_launches("modexp", M15, impl, e_bits=16)))
        for op, cols, want in calls:
            got, counts = self.launched_by(
                lambda: getattr(mod, op)(*cols, v))
            self.expect(f"cuda_pairs {op} launches", counts,
                        {"mul_pairs": want})
            if got != self.expected(op, cols, v):
                raise AssertionError(f"cuda_pairs {op} wrong")
            log(f"cuda_pairs {op}, 2^15-bit modulus: {counts}, exact")
        big = self.ModService(m_limbs=M18, batch_buckets=(4,),
                              device=self.dev, impl=impl)
        big.profile_bucket("precompute", 1)
        big.profile_bucket("reduce", 4)
        Lb = mod_operands(M18, 8, 2 ** 18)
        xs, v = Lb["x"][:4], Lb["v"]
        t0 = time.perf_counter()
        got, counts = self.launched_by(lambda: big.reduce(xs, v))
        self.expect("cuda_pairs 2^18-bit modulus launches", counts,
                    {"mul_pairs": CM.precompute_launches(M18, impl)
                     + CM.model_launches("reduce", M18, impl)})
        if got != [x % v for x in xs]:
            raise AssertionError("cuda_pairs reduce at a 2^18-bit modulus "
                                 "wrong")
        log(f"cuda_pairs reduce, 2^18-bit modulus, 4 lanes (precompute "
            f"included): {counts}, {time.perf_counter() - t0:.2f} s, exact")

    def frontend_chaos(self):
        """Seeded fault plans through AsyncFrontend at 2^15 bits: a compile
        fault on every cuda_fused plan degrades the division service to
        cuda_batched; two transient execute faults are retried; in both
        every answer equals the clean run's, bit for bit.  A compile
        fault on every cuda_pairs plan of ModArithService has no rung
        below it on the card, where the ladder never falls to the plain
        versions: every request fails with a typed error, and the only
        launches are the Barrett-context precomputes, which come before
        the compile site.  Nothing is dropped, and the quarantine set and the
        plans' degraded_from are as the plan says."""
        FS, FI = self.faults.FaultSpec, self.faults.FaultInjector
        div_reqs = self.div_requests(M15, DIV_REQUESTS, 150)
        plans = (
            ("compile fault on cuda_fused", self.Service(
                m_limbs=M15, batch_buckets=(16, 64), device=self.dev),
             div_reqs, self.frontend_answers["divmod 2^15"],
             [FS(site="compile", impl="cuda_fused", kind="compile",
                 times=0)], ("cuda_batched", "cuda_fused")),
            ("transient execute faults", self.Service(
                m_limbs=M15, batch_buckets=(16, 64), device=self.dev),
             div_reqs, self.frontend_answers["divmod 2^15"],
             [FS(site="execute", times=2)], None))
        for seed, (what, svc, reqs, clean, specs, degraded) in enumerate(
                plans):
            inj = FI(specs, seed=seed)
            outs, health, fe = self.serve(svc, reqs, inj)
            if outs != clean:
                raise AssertionError(f"chaos {what}: answers differ from "
                                     f"the clean run")
            tot = self.fe_totals(fe)
            buckets = sorted(svc.kernel_plans)
            got_plans = {b: (p.impl, p.degraded_from)
                         for b, p in svc.kernel_plans.items()}
            if degraded:
                self.expect(f"chaos {what} quarantine", health["quarantine"],
                            sorted(f"{degraded[1]}/b{b}/m{M15}"
                                   for b in buckets))
                self.expect(f"chaos {what} plans", got_plans,
                            {b: degraded for b in buckets})
                self.expect(f"chaos {what} retries, drops",
                            (tot["retries"], tot["dropped"]), (0, 0))
                if tot["degraded"] < 1 or tot["faults"] < len(buckets):
                    raise AssertionError(f"chaos {what}: {tot}")
            else:
                self.expect(f"chaos {what} quarantine",
                            health["quarantine"], [])
                self.expect(f"chaos {what} totals", tot,
                            dict(faults=2, degraded=0, retries=2, dropped=0))
            log(f"chaos {what}: answers == clean run, {tot}, quarantine "
                f"{health['quarantine']}, plans {got_plans}, fired "
                f"{inj.fired_total()}")
            self.report.setdefault("chaos", {})[what] = dict(
                totals=tot, health=health, faults=inj.stats())
        what = "compile fault on cuda_pairs"
        svc = self.ModService(m_limbs=M15, e_limbs=E_LIMBS,
                              batch_buckets=(16, 64), device=self.dev,
                              impl="cuda_pairs")
        inj = FI([FS(site="compile", impl="cuda_pairs", kind="compile",
                     times=0)], seed=len(plans))
        reqs = [r for r in self.mod_requests(M15, 151) if r[0] != "modexp"]
        svc.profile_bucket("precompute", 1)
        (outs, health, fe), counts = self.launched_by(
            lambda: self.serve(svc, reqs, inj, return_exceptions=True))
        if not (all(isinstance(o, self.errors.ServingError) for o in outs)
                and any(isinstance(o, self.errors.CompileFault)
                        for o in outs)):
            raise AssertionError(f"chaos {what}: not every request failed "
                                 f"typed: {outs}")
        tot = self.fe_totals(fe)
        # only the Barrett-context precomputes ran: they come before the
        # compile site, and no chunk ran on any impl
        self.expect(f"chaos {what} launches", counts,
                    {"mul_pairs": svc.ctx_misses * self.CM.precompute_launches(
                        M15, "cuda_pairs")})
        self.expect(f"chaos {what} plans", svc.kernel_plans, {})
        self.expect(f"chaos {what} quarantine", health["quarantine"],
                    [f"cuda_pairs/b{b}/m{M15}" for b in (16, 64)])
        self.expect(f"chaos {what} degraded, retries, drops",
                    (tot["degraded"], tot["retries"], tot["dropped"]),
                    (0, 0, 0))
        log(f"chaos {what}: {len(outs)} requests failed typed "
            f"({sorted({type(o).__name__ for o in outs})}), {tot}, "
            f"quarantine {health['quarantine']}, launches {counts} "
            f"({svc.ctx_misses} context precomputes), fired "
            f"{inj.fired_total()}")
        self.report.setdefault("chaos", {})[what] = dict(
            totals=tot, health=health, faults=inj.stats(),
            errors=[type(o).__name__ for o in outs])

    # -- phase 6c: the pair kernel's time ------------------------------------

    def conv_columns(self, u, v, m):
        """The library yardstick of the pair product: its column sums
        sum_i u[b, i] v[b, k - i], k < m, as ONE float64 grouped conv1d
        (one group per lane; exact when the algorithm sums directly, as
        every partial sum is an integer < 2^48).  Timed, never used by
        the port."""
        F, f64 = self.torch.nn.functional, self.torch.float64
        batch, wv = v.shape
        x = F.pad(u.to(f64)[None], (wv - 1, max(0, m - u.shape[1])))
        return F.conv1d(x[..., :wv - 1 + m], v.to(f64).flip(-1)[:, None],
                        groups=batch)[0]

    def library_pairs(self, q, v, m, got):
        """Time the conv1d yardstick at q*v and check it: its sums against
        the plain version's exact column sums, and their resolution
        against the kernel's limbs.  Where cuDNN's algorithm is inexact,
        time it again with cuDNN off (PyTorch's own convolution)."""
        torch, K = self.torch, self.K
        cols = K.pair_columns(K.pair_sums_plain(q, v, K.tiles_for(m)), m)
        out = {}
        for cudnn in (True, False):
            with torch.backends.cudnn.flags(enabled=cudnn):
                c = self.conv_columns(q, v, m)
                exact = bool(torch.equal(c, c.round())) and torch.equal(
                    c.to(torch.int64), cols)
                ms = self.time_ms(lambda: self.conv_columns(q, v, m),
                                  runs=3)
            out[f"cudnn_{cudnn}"] = dict(ms=ms, exact=exact)
            if exact:
                if not torch.equal(self.K.resolve_columns(
                        c.to(torch.int64)), got):
                    raise AssertionError("the exact column sums resolve to "
                                         "other limbs than the pair "
                                         "kernel's")
                out.update(ms=ms, exact=True, cudnn=cudnn)
                return out
        out.update(ms=None, exact=False, cudnn=None)
        return out

    def timing_pairs(self):
        """mul_pairs at the q*v shapes of the 2^15 x 256 and 2^18 x 32
        division cells beside mul_batch at the same shapes: CUDA events
        around each call, the pair kernel's and mul_batch's device times
        (torch.profiler), the whole mul_pairs call's device time and busy
        share (a memset beside the kernel), the plain version's time, the
        library yardstick (a float64 grouped conv1d of the column sums,
        `library_pairs`), the limb products per second per SM and the
        bound (the limb products of the truncated product, as for
        mul_batch)."""
        bm = self.bigmul
        rows = []
        for bits in (2 ** 15, 2 ** 18):
            u, v, q = self.main_inputs[bits]
            batch, m = q.shape
            work = self.CM.mul_work(batch, m, m, m)
            kernels = (lambda: bm.mul_pairs(q, v, m),
                       lambda: bm.mul_batch_cuda(q, v, m))
            dev = self.device_us(list(kernels))
            row = dict(bits=bits, batch=batch, limbs=m,
                       mul_pairs_ms=self.time_ms(
                           lambda: bm.mul_pairs(q, v, m)),
                       mul_pairs_kernel_device_ms=(dev[0] / 1e3 if dev
                                                   else None),
                       mul_pairs_kernel_burst_ms=self.burst_ms(kernels[0]),
                       mul_batch_ms=self.time_ms(kernels[1]),
                       mul_batch_kernel_device_ms=(dev[1] / 1e3 if dev
                                                   else None),
                       mul_batch_kernel_burst_ms=self.burst_ms(kernels[1]),
                       mul_pairs_plain_ms=self.time_ms(
                           lambda: bm.mul_pairs_reference(q, v, m), runs=3),
                       products=work[0], bytes=work[1])
            share = self.device_share(lambda: bm.mul_pairs(q, v, m))
            row.update(mul_pairs_call_device_ms=share["device_ms"],
                       mul_pairs_call_busy_share=share["device_busy_share"],
                       mul_pairs_call_device=share["device_by_kernel"],
                       library=self.library_pairs(q, v, m,
                                                  bm.mul_pairs(q, v, m)))
            kdev = row["mul_pairs_kernel_device_ms"] or \
                row["mul_pairs_kernel_burst_ms"]
            row["mul_pairs_rate_per_sm"] = self.rate(work[0], kdev)
            # the whole division under each kernel impl, in turns
            for impl in ("cuda_fused", "cuda_pairs", "cuda_pairs",
                         "cuda_fused"):
                ms = self.time_ms(lambda: self.S.divmod_batch(
                    u, v, impl=impl), runs=3)
                row.setdefault(f"divmod_{impl}_ms", []).append(ms)
            row["bound_ms"], row["bound_by"] = self.bound(*work)
            rows.append(row)
            log(json.dumps(row))
        r15, r18 = rows
        # the profiler's device time, or the burst where it saw nothing
        kms = lambda r, n: (r[f"{n}_kernel_device_ms"],
                            r[f"{n}_kernel_burst_ms"])
        self.agg["mul_pairs"] = dict(
            event_ms=r15["mul_pairs_ms"],
            device_ms=kms(r15, "mul_pairs")[0] or kms(r15, "mul_pairs")[1],
            ms_source="profiler" if kms(r15, "mul_pairs")[0] else
            "cuda_events over 20 back-to-back launches",
            plain_ms=r15["mul_pairs_plain_ms"], products=r15["products"],
            bytes=r15["bytes"], shape="q*v of the 2^15 x 256 division cell "
            "(2048 x 2048 -> 2048 limbs), beside mul_batch at that shape",
            call_device_ms=r15["mul_pairs_call_device_ms"],
            call_busy_share=r15["mul_pairs_call_busy_share"],
            library_ms=r15["library"]["ms"], library=r15["library"],
            rate_per_sm=r15["mul_pairs_rate_per_sm"])
        for name in ("mul_pairs", "mul_batch"):
            self.agg[name]["at_2p18"] = dict(
                shape="q*v of the 2^18 x 32 division cell (16384 x 16384 "
                "-> 16384 limbs)", event_ms=r18[f"{name}_ms"],
                device_ms=kms(r18, name)[0], burst_ms=kms(r18, name)[1],
                bound_ms=r18["bound_ms"], bound_by=r18["bound_by"])
        # the conv1d computes mul_batch's q*v product too: its yardstick
        self.agg["mul_batch"].update(library_ms=r15["library"]["ms"],
                                     library=r15["library"])
        self.agg["mul_batch"]["at_2p18"]["library"] = r18["library"]
        self.agg["mul_pairs"]["at_2p18"].update(
            plain_ms=r18["mul_pairs_plain_ms"], library=r18["library"],
            rate_per_sm=r18["mul_pairs_rate_per_sm"],
            call_busy_share=r18["mul_pairs_call_busy_share"])
        self.report["timing_pairs"] = rows

    # -- phase 7: the sharded services ----------------------------------------

    def two_shards(self):
        """A mesh of two shards: two cards where there are, else this
        card twice (each shard its own graph, pool and stream)."""
        from repro_torch.launch.mesh import make_device_mesh, mesh_of
        if self.torch.cuda.device_count() >= 2:
            return make_device_mesh(2)
        return mesh_of([self.dev, self.dev])

    def sharded_path(self):
        """BigintDivisionService at 2^18 bits and ModArithService at a
        2^15-bit modulus over two shards, beside the same services
        unsharded: every lane exact and equal to the unsharded answer,
        shards x the cost model's launches per chunk (the bucket graphs
        built first), one precompute per modulus."""
        CM, mesh = self.CM, self.two_shards()
        n = mesh.size
        self.sharded = {"mesh": [str(d) for d in mesh.devices]}
        div = self.Service(M18, batch_buckets=(32, 64), mesh=mesh)
        one = self.Service(M18, batch_buckets=(32, 64), device=self.dev)
        for svc in (div, one):
            for b in (32, 64):
                svc.profile_bucket(b)
        for rows in SHARD_DIV_ROWS:
            us, vs = operands(M18, rows, 19 + rows)
            got, k = self.launched(lambda: div.divide(us, vs))
            chunks = len(div.batcher.plan(rows))
            self.expect(f"sharded divmod launches ({rows} rows)", k,
                        n * chunks * (CM.divmod_launches(M18)
                                      + CM.prologue_launches()))
            if list(zip(*got)) != host_map(_divmod, zip(us, vs)):
                raise AssertionError("sharded divmod inexact")
            if got != one.divide(us, vs):
                raise AssertionError("sharded divmod differs from the "
                                     "unsharded service")
            log(f"sharded division 2^18 bits, {rows} rows in {chunks} "
                f"chunk(s) over {n} shards: {k} launches "
                f"({n} x {chunks} x "
                f"{CM.divmod_launches(M18) + CM.prologue_launches()}), exact, "
                f"equal to unsharded")
        m = M15
        kw = dict(e_limbs=E_LIMBS, batch_buckets=(64, 256))
        mod = self.ModService(m, mesh=mesh, **kw)
        mone = self.ModService(m, device=self.dev, **kw)
        for svc in (mod, mone):
            svc.profile_bucket("precompute", 1)
            for op, rows in SHARD_MOD_ROWS.items():
                svc.profile_bucket(op, rows)
        moduli, want, cols = [], {}, {}
        for seed in (151, 152):
            L = mod_operands(m, 256, seed)
            v = L["v"]
            moduli.append(v)
            cols[v] = {"reduce": (L["x"],), "modmul": (L["a"], L["b"]),
                       "modexp": (L["a"][:64], L["e"][:64])}
            want[v] = {"reduce": [x % v for x in L["x"]],
                       "modmul": [a * b % v for a, b in
                                  zip(L["a"], L["b"])],
                       "modexp": pow_all((a, e, v) for a, e in
                                         zip(*cols[v]["modexp"]))}
        model = {"reduce": CM.barrett_launches(),
                 "modmul": CM.modmul_launches(),
                 "modexp": CM.modexp_launches(16 * E_LIMBS)}
        for i, v in enumerate(moduli + moduli):
            for op in SHARD_MOD_ROWS:
                got, k = self.launched(
                    lambda: getattr(mod, op)(*cols[v][op], v))
                pre = CM.precompute_launches(m) + CM.prologue_launches() \
                    if i < 2 and op == "reduce" else 0
                self.expect(f"sharded {op} launches", k,
                            n * model[op] + pre)
                if got != want[v][op]:
                    raise AssertionError(f"sharded {op} inexact")
                if got != getattr(mone, op)(*cols[v][op], v):
                    raise AssertionError(f"sharded {op} differs from the "
                                         f"unsharded service")
        c = mod.stats()["ctx_cache"]
        self.expect("sharded context cache (misses, hits)",
                    (c["misses"], c["hits"]), (2, 10))
        log(f"sharded ModArithService, 2^15-bit moduli x2 interleaved: "
            f"reduce/modmul 256 rows, modexp 64 rows (256-bit "
            f"exponents) over {n} shards: exact, equal to unsharded, "
            f"{n} x model launches, one precompute per modulus")
        from repro_torch.obs import report as R
        for svc in (div, mod):
            snap = svc.snapshot()
            rows = R.measured_vs_model(snap)
            log(R.render_measured_vs_model(snap))
            if not all(r["match"] and r["model_launches"] for r in rows):
                raise AssertionError("sharded measured-vs-model mismatch")
        self.sharded.update(div=div, one=one, mod=mod, mone=mone, cols=cols,
                            moduli=moduli)
        self.report["sharded"] = dict(
            mesh=self.sharded["mesh"],
            shard_pool_bytes=[e.memory_bytes for e in div._fn(64).shards])

    def guard_us(self, n=20000):
        """Host microseconds per launch of `build.on_device` (the device
        guard every wrapper runs its launch under) beside `stream_ptr`
        alone (what a launch asked before the guard), on a tensor of the
        current card."""
        t = self.torch.zeros(1, device=self.dev)
        out = {}
        for name in ("stream_ptr", "on_device", "on_device", "stream_ptr"):
            t0 = time.perf_counter()
            if name == "on_device":
                for _ in range(n):
                    with self.build.on_device(t):
                        pass
            else:
                for _ in range(n):
                    self.build.stream_ptr(t)
            out.setdefault(name, []).append(
                (time.perf_counter() - t0) / n * 1e6)
        return out

    def timing_sharded(self):
        """The sharded services' calls against the unsharded ones, in
        turns (unsharded, sharded, sharded, unsharded), host clock to
        the answer (packing included): a record, not a claim.  Also the
        device guard's host cost per launch (`guard_us`)."""
        sh = self.sharded
        guard = self.guard_us()
        log(f"device guard per launch (us, in turns): {guard}")
        us, vs = operands(M18, 64, 83)
        cases = [("divmod 2^18 x 64", lambda s: s.divide(us, vs), "div",
                  "one")]
        v = sh["moduli"][0]
        for op, rows in SHARD_MOD_ROWS.items():
            cases.append((f"{op} 2^15-bit modulus x {rows}",
                          lambda s, op=op: getattr(s, op)(
                              *sh["cols"][v][op], v), "mod", "mone"))
        out = {}
        for name, call, shd, base in cases:
            ts = {"unsharded": [], "sharded": []}
            for which in ("unsharded", "sharded", "sharded", "unsharded"):
                svc = sh[shd if which == "sharded" else base]
                call(svc)                              # warm
                t0 = time.perf_counter()
                call(svc)
                ts[which].append((time.perf_counter() - t0) * 1e3)
            out[name] = ts
            log(f"sharded timing {name}: unsharded {ts['unsharded']} ms, "
                f"sharded {ts['sharded']} ms (mesh {sh['mesh']})")
        self.report["timing_sharded"] = dict(card=card_line(),
                                             mesh=sh["mesh"], calls=out,
                                             guard_us=guard)

    # -- phase 8: the dry run ------------------------------------------------

    def dryrun(self):
        """`launch/bigint_dryrun.py --limbs 16384 --insts 8192`: one
        32-row shard of the 256-shard production layout at 2^18 bits,
        exact, with divmod_launches(16384) launches and a roofline equal
        to the sum of its launches' terms (obs/roofline.py over
        costmodel.divmod_work)."""
        from repro_torch.launch import bigint_dryrun as DR
        CM, RL = self.CM, self.RL
        out = ROOT / "results" / "dryrun" / "bigint_div.json"
        rec = DR.main(["--limbs", str(M18), "--insts", str(DRYRUN_INSTS),
                       "--out", str(out)])
        if not rec["exact"] or rec["status"] != "ok":
            raise AssertionError("dry run inexact")
        self.expect("dry run launches", rec["launches"]["per_shard"],
                    CM.divmod_launches(M18) + CM.prologue_launches())
        self.expect("dry run shard rows", rec["rows_per_shard"],
                    DRYRUN_INSTS // 256)
        work = CM.divmod_work(M18, rec["rows_per_shard"])
        per = [RL.roofline_terms([w]) for w in work]
        for key in ("compute_s", "memory_s"):
            total = sum(p[key] for p in per)
            if abs(rec["roofline"][key] - total) > 1e-9 * total:
                raise AssertionError(f"dry run {key} {rec['roofline'][key]}"
                                     f" != the launches' sum {total}")
        io = 4 * rec["rows_per_shard"] * M18 * 4
        if rec["memory"]["peak_bytes_est"] < io:
            raise AssertionError("dry run peak below its inputs and outputs")
        bound_ms = sum(RL.bound(w[1], w[2])[0] for w in work) * 1e3
        log(f"dry run 2^18 bits x {DRYRUN_INSTS} over 256 shards: one "
            f"{rec['rows_per_shard']}-row shard, {rec['launches']} launches, "
            f"compile {rec['compile_s']} s, peak {rec['memory']}, replay "
            f"{rec['replay_s'] * 1e3:.3f} ms against the launches' bounds' "
            f"sum {bound_ms:.4f} ms, roofline {rec['roofline']}")
        self.report["dryrun"] = dict(
            {k: rec[k] for k in rec if k != "launch_work"},
            bound_sum_ms=bound_ms)

    # -- phase 9: LM serving --------------------------------------------------

    def lm_serve(self):
        """The LM path (`repro_torch.models`), which launches none of the
        six kernels: (a) every registered arch, reduced, in float32, one
        set of weights on the CPU and a copy on the card: prefill logits,
        8 greedy decode steps and their tokens against the CPU's
        (whisper over the cross cache its encoder fills); (b)-(c) the
        LM_FULL archs at published width, in bf16 (`lm_full`); (d)
        `python -m repro_torch.launch.serve` for the LM demo (smollm and
        rwkv6-7b) and the division service, and the long-context RWKV
        example, as child processes."""
        from repro_torch import configs as C
        from repro_torch.models import transformer as T
        rep = self.report["lm_serve"] = {"reduced": {}, "full": {},
                                         "seconds": {}}
        t0 = time.perf_counter()
        for arch in LM_ARCHS:
            rep["reduced"][arch] = self.lm_reduced(C, T, arch)
        rep["seconds"]["reduced"] = time.perf_counter() - t0
        for arch, cuts, prefill, batch, steps, f32 in LM_FULL:
            t0 = time.perf_counter()
            rep["full"][arch] = self.lm_full(C, T, arch, cuts, prefill,
                                             batch, steps, f32)
            rep["seconds"][arch] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["cli"] = self.lm_cli()
        rep["seconds"]["cli"] = time.perf_counter() - t0
        log(f"lm_serve seconds: {json.dumps(rep['seconds'])}")

    def lm_close(self, what, got, want, tol):
        """Max |got - want| in float32; raises unless every element is
        within atol = rtol = tol."""
        torch = self.torch
        got, want = got.float().cpu(), want.float().cpu()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise AssertionError(f"{what}: max abs err {err} past "
                                 f"rtol = atol = {tol}")
        return err

    def lm_batch(self, cfg, toks, gen):
        """An arch's prefill batch for tokens (B, S): the tokens, or
        random embeddings for an embed_stub decoder-only arch; whisper
        also takes enc_seq random encoder frames (which fill its cross
        cache, `lm_cache`)."""
        torch = self.torch
        b, s = toks.shape
        dev = toks.device
        if cfg.family == "encdec":
            return {"tokens": toks, "enc_embeds": torch.randn(
                (b, cfg.enc_seq, cfg.d_model), generator=gen,
                device=gen.device).to(dev)}
        if cfg.embed_stub:
            return {"embeds": torch.randn((b, s, cfg.d_model), generator=gen,
                                          device=gen.device).to(dev)}
        return {"tokens": toks}

    @staticmethod
    def lm_cache(T, model, b, max_seq, batch, device):
        """A zero decode cache; whisper's cross cache filled from its
        encoder over batch["enc_embeds"]."""
        cache = T.init_cache(model.cfg, b, max_seq, device)
        if model.cfg.family == "encdec":
            T.encode_cross(model, cache, batch)
        return cache

    @staticmethod
    def lm_prompt(cfg) -> int:
        """Decode-against-prefill positions: LM_PROMPT, or
        LM_PROMPT_CHUNKED for RWKV, whose prefill takes the chunked WKV
        form from 128 positions."""
        return LM_PROMPT_CHUNKED if cfg.family == "ssm" else LM_PROMPT

    def lm_reduced(self, C, T, arch):
        torch = self.torch
        cfg = C.get_config(arch).reduced()
        cpu = T.init_params(cfg, 0, "cpu")
        card = copy.deepcopy(cpu).to(self.dev)
        gen = torch.Generator().manual_seed(0)
        b, s = 2, self.lm_prompt(cfg)
        toks = torch.randint(0, cfg.vocab, (b, s), generator=gen)
        batch = self.lm_batch(cfg, toks, gen)
        on_card = {k: v.to(self.dev) for k, v in batch.items()}
        want = T.forward_prefill(cpu, batch)
        got = T.forward_prefill(card, on_card)
        rec = {"prefill_err": self.lm_close(f"{arch} prefill", got, want,
                                            LM_TOL_F32)}
        cc = self.lm_cache(T, cpu, b, LM_GREEDY, batch, "cpu")
        gc = self.lm_cache(T, card, b, LM_GREEDY, on_card, self.dev)
        tc, errs = toks[:, 0], []
        for i in range(LM_GREEDY):
            lc, cc = T.forward_decode(cpu, cc, {"token": tc}, i)
            lg, gc = T.forward_decode(card, gc, {"token": tc.to(self.dev)}, i)
            errs.append(self.lm_close(f"{arch} decode step {i}", lg, lc,
                                      LM_TOL_DECODE))
            tc = lc[:, :cfg.vocab].argmax(-1)
            if not torch.equal(lg[:, :cfg.vocab].argmax(-1).cpu(), tc):
                raise AssertionError(f"{arch}: greedy tokens differ at "
                                     f"step {i}")
        rec["decode_err"] = max(errs)
        log(f"lm {arch} reduced, card vs CPU (float32): prefill err "
            f"{rec['prefill_err']:.3g} ({s} positions), {LM_GREEDY} decode "
            f"steps err {rec['decode_err']:.3g}, greedy tokens equal")
        return rec

    def lm_full(self, C, T, arch, cuts, prefill, batch, steps, with_f32):
        """One arch at its published width (and depth, or as `cuts`), bf16
        weights from seed 0 built on the card, and, `with_f32`, a float32
        copy of them: decode of a prompt against its prefill (the copy at
        JAX's tolerance, the bf16 model at bf16's; RWKV's in
        `lm_wkv_checks`); greedy steps of the bf16 model against the copy
        (not RWKV's); then prefill and decode timed, the
        device's busy share of each (torch.profiler), tokens/s, peak
        memory, and the bounds."""
        torch = self.torch
        cfg = dataclasses.replace(C.get_config(arch), **cuts)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = T.init_params(cfg, 0, self.dev)
        torch.cuda.synchronize()
        params = list(model.parameters())
        rec = dict(layers=cfg.n_layers, build_s=time.perf_counter() - t0,
                   n_params=sum(p.numel() for p in params),
                   weight_bytes=sum(p.numel() * p.element_size()
                                    for p in params))
        gen = torch.Generator(device=self.dev).manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (batch, self.lm_prompt(cfg)),
                               generator=gen, device=self.dev)
        pbatch = self.lm_batch(cfg, prompt, gen)
        t0 = time.perf_counter()
        checks = [("bf16", model, LM_TOL_BF16)]
        if with_f32:
            m32 = copy.deepcopy(model).to(torch.float32)
            m32.cfg = dataclasses.replace(cfg, dtype="float32",
                                          param_dtype_str="float32")
            checks.insert(0, ("float32", m32, LM_TOL_JAX))
        if cfg.family == "ssm":
            rec.update(self.lm_wkv_checks(T, model, m32, pbatch))
        else:
            for name, m, tol in checks:
                got = self.lm_decode_vs_prefill(T, m, pbatch, tol)
                got.update(tol=tol)
                rec.update({f"decode_vs_prefill_{name}_{k}": v
                            for k, v in got.items()})
            if with_f32:
                rec.update(self.lm_vs_f32(T, model, m32, pbatch))
        if with_f32:
            del m32, checks
        rec["checks_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec.update(self.lm_timing(T, model, cfg, prefill, batch, steps, gen))
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["timing_s"] = time.perf_counter() - t0
        log(f"lm {arch} ({cfg.n_layers} layers, {rec['n_params']:,} "
            f"params, bf16): {json.dumps(rec)}")
        del model
        torch.cuda.empty_cache()
        return rec

    def lm_wkv_checks(self, T, model, m32, batch):
        """RWKV at full width: decode of the prompt against its prefill on
        the first n layers of the same weights (`first_layers`), the
        float32 copy at each depth of LM_WKV_F32 within its limit, the
        bf16 model on LM_WKV_LAYERS within LM_TOL_WKV_BF16; at the full
        depth the bf16 prefill's and LM_GREEDY decode steps' logits
        finite.  No greedy steps against the copy: bf16 puts RWKV's
        logits further from float32's than LM_TOL_BF16 (LM_WKV_F32)."""
        torch = self.torch
        rec = {}
        for name, m, limits in (
                ("float32", m32, LM_WKV_F32),
                ("bf16", model, {LM_WKV_LAYERS: LM_TOL_WKV_BF16})):
            for depth, tol in limits.items():
                got = self.lm_decode_vs_prefill(
                    T, T.first_layers(m, depth), batch, tol)
                got.update(tol=tol)
                rec.update({f"decode_vs_prefill_{name}_{depth}l_{k}": v
                            for k, v in got.items()})
        prompt = batch["tokens"]
        logits = [T.forward_prefill(model, batch)]
        cache = T.init_cache(model.cfg, prompt.shape[0], LM_GREEDY, self.dev)
        for i in range(LM_GREEDY):
            out, cache = T.forward_decode(model, cache,
                                          {"token": prompt[:, i]}, i)
            logits.append(out)
        if not all(torch.isfinite(x).all() for x in logits):
            raise AssertionError(f"{model.cfg.name} (bf16, full depth): "
                                 "non-finite logits")
        return rec

    @contextmanager
    def forced_routing(self, routed):
        """Within it, each MoE layer of `routed` ({id(MoE module): (B, S,
        k) expert ids}) routes decode position `state.pos` to those
        experts through `moe.dispatch`, as `moe.route` dispatches its own
        top k (the router's probabilities renormalised over them, the
        call's capacity).  `state.flipped` marks the rows whose own top k
        differed at some position.  It lives in the check; the port's API
        has no such hook."""
        from repro_torch.models import moe as MOE
        orig = MOE.route
        state = types.SimpleNamespace(pos=0, flipped=None)

        def route(p, xt, cfg):
            r = orig(p, xt, cfg)
            want = routed.get(id(p))
            if want is None:
                return r
            experts = want[:, state.pos]                    # (B, k)
            differ = (r.experts != experts).any(-1)
            state.flipped = differ if state.flipped is None \
                else state.flipped | differ
            return MOE.dispatch(r.probs, experts, r.cap)

        MOE.route = route
        try:
            yield state
        finally:
            MOE.route = orig

    def lm_decode_vs_prefill(self, T, model, batch, tol):
        """Step-by-step decode of batch["tokens"] against its prefill
        (whisper over the cross cache its encoder fills from the prefill's
        frames): every logit finite, the last position's logits within
        rtol = atol = tol on every row.  A MoE runs at a capacity factor
        that fits every slot (a prefill routes all positions against one
        capacity and may drop what one-token steps keep), and its decode
        steps take the prefill's expert ids (`forced_routing`): a router
        near-tie that rounding tips between the two paths would otherwise
        send a row through other experts.  The rows whose own decode
        routing differed are counted."""
        torch = self.torch
        cfg = model.cfg
        check = copy.copy(model)            # the same modules, its own cfg
        if cfg.n_experts:
            check.cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
        moe = [blk.moe for blk in model.blocks if hasattr(blk, "moe")]
        prompt = batch["tokens"]
        b, s = prompt.shape
        full = T.forward_prefill(check, batch)
        routed = {id(m): m.routing.experts.reshape(b, s, -1) for m in moe}
        cache = self.lm_cache(T, check, b, s, batch, self.dev)
        with self.forced_routing(routed) as forced:
            for i in range(s):
                forced.pos = i
                logits, cache = T.forward_decode(check, cache,
                                                 {"token": prompt[:, i]}, i)
        if not (torch.isfinite(full).all() and torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name}: non-finite logits")
        err = self.lm_close(f"{cfg.name} ({cfg.dtype}, {cfg.n_layers} "
                            "layers) decode vs prefill", logits, full, tol)
        flipped = 0 if forced.flipped is None else int(forced.flipped.sum())
        return dict(err=err, rows=b, rows_compared=b, positions=s,
                    routing_flipped_rows=flipped)

    def lm_vs_f32(self, T, model, m32, batch):
        """LM_GREEDY greedy steps of the bf16 model beside its float32
        copy from batch["tokens"][:, 0] (whisper over the cross caches
        each fills from batch's frames), both fed the float32 run's
        tokens.  A row whose MoE routing differs between the two (a router
        near-tie tipped by bf16 activations: another expert, another
        output) is counted and left out; on the other rows the logits
        agree within LM_TOL_BF16, and the greedy tokens are equal wherever
        the float32 top-2 margin exceeds twice that tolerance at the top
        logit (nearer ties may go either way in bf16)."""
        torch = self.torch
        cfg = model.cfg
        moe = [(a.moe, c.moe) for a, c in zip(model.blocks, m32.blocks)
               if hasattr(a, "moe")]
        first = batch["tokens"][:, 0]
        b = first.shape[0]
        c16 = self.lm_cache(T, model, b, LM_GREEDY, batch, self.dev)
        c32 = self.lm_cache(T, m32, b, LM_GREEDY, batch, self.dev)
        tok, err, equal, clear_n, flipped, differ = first, 0.0, 0, 0, 0, []
        worst = 0.0             # the widest float32 margin bf16 crossed
        for i in range(LM_GREEDY):
            l16, c16 = T.forward_decode(model, c16, {"token": tok}, i)
            l32, c32 = T.forward_decode(m32, c32, {"token": tok}, i)
            l16, l32 = l16[:, :cfg.vocab].float(), l32[:, :cfg.vocab]
            same = torch.ones(b, dtype=torch.bool, device=self.dev)
            for a, c in moe:
                same &= (a.routing.experts == c.routing.experts).all(-1)
            flipped += int((~same).sum())
            err = max(err, (l16 - l32)[same].abs().max().item()
                      if same.any() else 0.0)
            if not torch.allclose(l16[same], l32[same], rtol=LM_TOL_BF16,
                                  atol=LM_TOL_BF16):
                differ.append(i)
            top2 = l32.topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            clear = same & (margin > 2 * LM_TOL_BF16 * (1 + top2[:, 0].abs()))
            a16, a32 = l16.argmax(-1), l32.argmax(-1)
            if not torch.equal(a16[clear], a32[clear]):
                differ.append(f"token at step {i}")
            if (a16 != a32).any():
                worst = max(worst, margin[a16 != a32].max().item())
            equal += int((a16 == a32).sum())
            clear_n += int(clear.sum())
            tok = a32
        rec = dict(bf16_vs_f32_err=err, greedy_equal=equal,
                   greedy_total=LM_GREEDY * b, greedy_clear=clear_n,
                   routing_flipped_rows=flipped, widest_crossed_margin=worst)
        if differ:
            raise AssertionError(f"{cfg.name}: bf16 against float32 "
                                 f"differs at {differ}: {rec}")
        return rec

    @staticmethod
    def lm_work(T, model, cfg):
        """What the bounds count, from the model's parameters: `tok` the
        matrix entries one decoder position multiplies by (every layer's
        mixer and ffn, router included, MoE experts and the cross
        attention's K/V projections excluded), `frame` the cross
        attention's K/V entries one encoder frame meets, `enc` those of
        the encoder layers, `expert` one expert's, `head` the logits'.
        Depthwise and elementwise leaves (RWKV's mu and u, Mamba's conv
        and a_log) are not products."""
        elementwise = ("tm.mu", "tm.u", "mamba.conv_w", "mamba.a_log")
        tok = frame = 0
        for blk in model.blocks:
            for name, p in blk.named_parameters():
                if p.ndim < 2 or name.startswith(elementwise + ("moe.w",)):
                    continue
                if name.startswith(("xattn.wk", "xattn.wv")):
                    frame += p.numel()
                else:
                    tok += p.numel()
        enc = sum(p.numel() for blk in getattr(model, "enc_blocks", ())
                  for p in blk.parameters() if p.ndim >= 2)
        mats = 3 if cfg.act == "swiglu" else 2
        return dict(tok=tok, frame=frame, enc=enc,
                    expert=mats * cfg.d_model * cfg.moe_d_ff,
                    head=cfg.d_model * T.vocab_padded(cfg))

    def lm_timing(self, T, model, cfg, prefill, batch, steps, gen):
        torch = self.torch
        pb, ps = prefill
        toks = torch.randint(0, cfg.vocab, (pb, ps), generator=gen,
                             device=self.dev)
        pbatch = self.lm_batch(cfg, toks, gen)

        def run_prefill():
            return T.forward_prefill(model, pbatch)

        prefill_ms = self.time_ms(run_prefill)
        encode_ms = self.time_ms(lambda: T._encode(model, pbatch)) \
            if cfg.family == "encdec" else None
        moe = [blk.moe for blk in model.blocks if hasattr(blk, "moe")]
        run_prefill()
        dropped = sum(int((~m.routing.keep).sum()) for m in moe)
        kept = pb * ps * cfg.moe_top_k * len(moe) - dropped
        dbatch = self.lm_batch(cfg, toks[:1].expand(batch, ps), gen)
        cache = self.lm_cache(T, model, batch, ps + steps, dbatch, self.dev)
        for st in cache:                # the prefill's positions: history
            for name, t in st.items():
                if name in ("k", "v"):
                    t[:, :ps].normal_(generator=gen)
                elif name not in ("ck", "cv"):    # a recurrent state
                    t.normal_(generator=gen)
        first = torch.randint(0, cfg.vocab, (batch,), generator=gen,
                              device=self.dev)

        def run_decode(n=steps, events=None, routed=None):
            """n greedy steps; each step's CUDA events into `events`, the
            MoE layers' routed experts per step into `routed`."""
            tok = first
            for i in range(n):
                if events is not None:
                    events.append((torch.cuda.Event(enable_timing=True),
                                   torch.cuda.Event(enable_timing=True)))
                    events[-1][0].record()
                logits, _ = T.forward_decode(model, cache, {"token": tok},
                                             ps + i)
                tok = logits[:, :cfg.vocab].argmax(-1)
                if events is not None:
                    events[-1][1].record()
                if routed is not None:
                    routed.append(sum(int(m.routing.experts.unique().numel())
                                      for m in moe))
            return tok

        experts, step_ms = [], []
        run_decode(routed=experts)           # warm-up
        run_decode(events=step_ms)
        torch.cuda.synchronize()
        decode_ms = statistics.median(a.elapsed_time(b) for a, b in step_ms)
        prof_p = self.device_share(run_prefill)
        prof_n = min(steps, LM_GREEDY)
        prof_d = self.device_share(lambda: run_decode(prof_n))
        rec = dict(prefill=f"{pb} x {ps}", prefill_ms=prefill_ms,
                   encode_ms=encode_ms)
        rec.update(self.lm_bounds(T, model, cfg, pb, ps, kept, batch, steps,
                                  statistics.mean(experts) if moe else None))
        rec.update(
            prefill_tokens_s=pb * ps / prefill_ms * 1e3,
            prefill_busy_share=prof_p["device_busy_share"],
            prefill_host_share=None if prof_p["device_busy_share"] is None
            else 1 - prof_p["device_busy_share"],
            decode=f"{steps} steps at batch {batch}, positions {ps}.."
                   f"{ps + steps - 1} after {ps} positions of history",
            decode_ms_per_step=decode_ms,
            decode_tokens_s=batch / decode_ms * 1e3,
            decode_busy_share=prof_d["device_busy_share"],
            decode_host_share=None if prof_d["device_busy_share"] is None
            else 1 - prof_d["device_busy_share"],
            decode_device_ms_per_step=None if prof_d["device_ms"] is None
            else prof_d["device_ms"] / prof_n,
            prefill_dropped=dropped if moe else None,
            prefill_slots=pb * ps * cfg.moe_top_k * len(moe) if moe
            else None)
        if any(mixer == "attn" for mixer, _ in T.layer_slots(cfg)):
            rec.update(self.lm_sdpa(T, cfg, pb, ps, gen))
        return rec

    def lm_bounds(self, T, model, cfg, pb, ps, kept, batch, steps, routed):
        """The least time the card could take (989 TFLOP/s bf16, 3.35
        TB/s: `roofline.flop_bound`).  Prefill: every position through
        its layers' products (a MoE's kept slots only), the causal
        attention (half the square), the recurrences' state updates
        (RWKV 6 d hd, Mamba 7 di N per position and layer), whisper's
        encoder over its frames (non-causal attention, the whole square)
        and its cross attention (K/V of every frame, scores against every
        frame), the last position's head; all weights read once.  Decode,
        per step: the weights it multiplies (the routed experts of a MoE;
        not the encoder, the cross K/V projections or the embedding
        table, of which it gathers rows), the attention history it reads,
        the recurrent states read and written, the cross cache read, the
        logits written."""
        w = self.lm_work(T, model, cfg)
        slots = T.layer_slots(cfg)
        n_attn = sum(1 for mixer, _ in slots if mixer == "attn")
        n_rwkv = sum(1 for mixer, _ in slots if mixer == "rwkv")
        n_mamba = sum(1 for mixer, _ in slots if mixer == "mamba")
        n_moe = sum(1 for _, ffn in slots if ffn.startswith("moe"))
        d, hd, h, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        di = cfg.mamba_d_inner or 2 * d
        vp = T.vocab_padded(cfg)
        enc = cfg.enc_seq if cfg.family == "encdec" else 0
        n_enc = cfg.n_enc_layers if enc else 0
        rwkv_hd = d // h
        flops = 2 * pb * ps * w["tok"] + 2 * kept * w["expert"] \
            + 2 * n_attn * pb * ps * (ps + 1) * h * hd \
            + 6 * n_rwkv * pb * ps * d * rwkv_hd \
            + 7 * n_mamba * pb * ps * di * 16 \
            + 2 * pb * enc * w["enc"] + 4 * n_enc * pb * enc * enc * h * hd \
            + 2 * pb * enc * w["frame"] \
            + 4 * (cfg.n_layers if enc else 0) * pb * ps * enc * h * hd \
            + 2 * pb * w["head"]
        psize = 2                            # bf16
        all_bytes = sum(p.numel() * p.element_size()
                        for p in model.parameters())
        p_bound = self.RL.flop_bound(flops, all_bytes)
        # decode
        skip = ("xattn.wk", "xattn.wv", "moe.w")
        w_bytes = sum(p.numel() * p.element_size()
                      for blk in model.blocks
                      for name, p in blk.named_parameters()
                      if not name.startswith(skip))
        w_bytes += psize * (w["head"] + 2 * d)          # head, final_ln
        if routed is not None:
            w_bytes += routed * psize * w["expert"]
        positions = statistics.mean(ps + i + 1 for i in range(steps))
        kv = 2 * n_attn * batch * hkv * hd * psize * positions
        state = 2 * 4 * batch * (n_rwkv * h * rwkv_hd ** 2
                                 + n_mamba * di * 16) \
            + 2 * psize * batch * (2 * n_rwkv * d + n_mamba * 3 * di)
        cross = 2 * cfg.n_layers * batch * enc * hkv * hd * psize
        d_flops = 2 * batch * (w["tok"] + w["head"]
                               + cfg.moe_top_k * n_moe * w["expert"]) \
            + 4 * n_attn * batch * positions * h * hd \
            + 6 * n_rwkv * batch * d * rwkv_hd \
            + 7 * n_mamba * batch * di * 16 \
            + 4 * cfg.n_layers * batch * enc * h * hd
        d_bytes = w_bytes + kv + state + cross + batch * vp * psize
        d_bound = self.RL.flop_bound(d_flops, d_bytes)
        return dict(prefill_flops=flops, prefill_bound_ms=p_bound[0] * 1e3,
                    prefill_bound_by=p_bound[1], decode_bytes=d_bytes,
                    decode_state_bytes=state + kv + cross,
                    decode_bound_ms=d_bound[0] * 1e3,
                    decode_bound_by=d_bound[1],
                    routed_experts_per_step=routed)

    def lm_sdpa(self, T, cfg, b, s, gen):
        """A yardstick for a later PR: one layer's chunked attention core
        at the prefill shape against `scaled_dot_product_attention` on the
        same bf16 q, k, v (causal, kv heads repeated), and their max
        difference."""
        torch = self.torch
        from repro_torch.models import layers as L
        shape = (b, s, cfg.n_heads, cfg.head_dim)
        q, k, v = (torch.randn(shape, generator=gen, device=self.dev,
                               dtype=torch.bfloat16) for _ in range(3))

        def core():
            return L.attn_core_chunked(q, k, v, cfg.attn_chunk)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True).transpose(1, 2)

        err = (core().float() - sdpa().float()).abs().max().item()
        return dict(attn_core_ms=self.time_ms(core),
                    sdpa_ms=self.time_ms(sdpa), attn_core_vs_sdpa_err=err)

    def lm_cli(self):
        """Child processes on the card, started together: `python -m
        repro_torch.launch.serve` for the LM demo (reduced smollm, 32
        tokens; reduced rwkv6-7b, 8 tokens) and the division service
        (--bigint, 256 limbs x 64), and the long-context RWKV example;
        each must exit 0 and print what it prints on success."""
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        serve = "repro_torch.launch.serve"
        runs = {
            "lm": ([serve, "--arch", "smollm-135m", "--tokens", "32"],
                   "decoded 32 tokens"),
            "lm_rwkv": ([serve, "--arch", "rwkv6-7b", "--tokens", "8"],
                        "decoded 8 tokens"),
            "bigint": ([serve, "--bigint", "--limbs", "256", "--batch",
                        "64"], "all exact"),
            "long_context_rwkv": (["repro_torch.examples.long_context_rwkv"],
                                  "position 524287")}
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", *argv], env=env, cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for name, (argv, _) in runs.items()}
        out, failed = {}, []
        for name, p in procs.items():
            try:
                stdout, stderr = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
            argv, want = runs[name]
            out[name] = dict(seconds=time.perf_counter() - t0,
                             rc=p.returncode,
                             stdout=stdout.strip().splitlines())
            log(f"{' '.join(argv)}: rc {p.returncode}, {out[name]['stdout']}")
            if p.returncode != 0 or want not in stdout:
                failed.append(f"{' '.join(argv)}: rc {p.returncode}\n"
                              f"{stdout[-2000:]}\n{stderr[-2000:]}")
        if failed:
            raise AssertionError("\n".join(failed))
        return out

    # -- phase 10: LM training ---------------------------------------------

    def lm_train(self):
        """The training path (`repro_torch.train`), which launches none of
        the six kernels: the child processes of (c) and (e) start first
        and run beside (a); (b) and its timing (d) run after they end."""
        from repro_torch import configs as C
        rep = self.report["lm_train"] = {"reduced": {}, "seconds": {}}
        t0 = time.perf_counter()
        procs = self.train_children()
        for arch in LM_ARCHS:
            rep["reduced"][arch] = self.train_reduced(C, arch)
        rep["seconds"]["reduced"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["cli"] = self.train_children_check(procs)
        rep["seconds"]["cli"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["full"] = self.train_full(C)
        rep["seconds"]["full"] = time.perf_counter() - t0
        log(f"lm_train seconds: {json.dumps(rep['seconds'])}")

    @staticmethod
    def train_batch(cfg, b, s, gen, device):
        """A train batch (B, S): labels, tokens or (an embed_stub
        decoder-only arch) embeddings, and whisper's 100 frames."""
        import torch
        batch = {"labels": torch.randint(0, cfg.vocab, (b, s), generator=gen)}
        if cfg.embed_stub and cfg.family != "encdec":
            batch["embeds"] = torch.randn((b, s, cfg.d_model), generator=gen)
        else:
            batch["tokens"] = torch.randint(0, cfg.vocab, (b, s),
                                            generator=gen)
        if cfg.family == "encdec":
            batch["enc_embeds"] = torch.randn((b, 100, cfg.d_model),
                                              generator=gen)
        return {k: v.to(device) for k, v in batch.items()}

    def train_close(self, what, got, want, rtol, atol):
        """Max |got - want| / max |want|; raises unless every element is
        within rtol and atol."""
        torch = self.torch
        got, want = got.detach().float().cpu(), want.detach().float().cpu()
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            err = (got - want).abs().max().item()
            raise AssertionError(f"{what}: max abs err {err} past rtol "
                                 f"{rtol}, atol {atol}")
        scale = want.abs().max().item()
        return (got - want).abs().max().item() / scale if scale else 0.0

    def train_reduced(self, C, arch):
        """One train step of the reduced arch in float32, card against
        CPU (module docstring, 10a)."""
        torch = self.torch
        from repro_torch.models import transformer as T
        from repro_torch.optim import adamw
        from repro_torch.train import step as TS
        cfg = C.get_config(arch).reduced()
        ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=2)
        cpu = T.init_params(cfg, 0, "cpu")
        card = copy.deepcopy(cpu).to(self.dev)
        gen = torch.Generator().manual_seed(0)
        batch = self.train_batch(cfg, 2, self.lm_prompt(cfg), gen, "cpu")
        on_card = {k: v.to(self.dev) for k, v in batch.items()}
        rtol, atol = TRAIN_TOL_GRAD

        def leaf_atol(name, want):
            frac = TRAIN_STREAM_ATOL if any(
                k in name for k in TRAIN_STREAM_LEAVES) else atol
            return frac * want.abs().max().item()

        lc, mc, gc = TS.make_grad_fn(cfg)(cpu, batch)
        lg, mg, gg = TS.make_grad_fn(cfg)(card, on_card)
        rec = dict(loss=lc.item(), aux=mc["aux"].item(),
                   loss_err=self.train_close(f"{arch} loss", lg, lc,
                                             TRAIN_TOL_LOSS, 0))
        rec["grad_err"] = max(
            self.train_close(f"{arch} grad {k}", gg[k], g, rtol,
                             leaf_atol(k, g)) for k, g in gc.items())
        # the update: the card's gradients applied on both devices
        card_g = {k: g.float() for k, g in gg.items()}
        oc = TS.apply_grads(cpu, adamw.init_state(
            dict(cpu.named_parameters()), ocfg),
            {k: g.cpu() for k, g in card_g.items()}, ocfg)
        og = TS.apply_grads(card, adamw.init_state(
            dict(card.named_parameters()), ocfg), card_g, ocfg)
        if not int(og["step"]) == int(oc["step"]) == 1:
            raise AssertionError(f"{arch}: AdamW steps {og['step']}, "
                                 f"{oc['step']}")
        urtol, uatol = TRAIN_TOL_UPDATE
        rec["param_err"] = max(
            self.train_close(f"{arch} param {k}", q, p, urtol,
                             uatol * TRAIN_LR)
            for (k, p), q in zip(cpu.named_parameters(), card.parameters()))
        rec["moment_err"] = max(
            self.train_close(f"{arch} {m} {k}", og[m][k], t, urtol,
                             uatol * t.abs().max().item())
            for m in ("m", "v") for k, t in oc[m].items())
        # then one make_train_step step from there on each device
        step = TS.make_train_step(cfg, ocfg)
        _, oc, mc = step(cpu, oc, batch)
        _, og, mg = step(card, og, on_card)
        rec["step_loss_err"] = self.train_close(
            f"{arch} train step loss", mg["loss"], mc["loss"],
            TRAIN_TOL_LOSS, 0)
        if not all(torch.isfinite(p).all() for p in card.parameters()):
            raise AssertionError(f"{arch}: non-finite parameters")
        log(f"lm_train {arch} reduced, card vs CPU (float32): "
            f"{json.dumps(rec)}")
        return rec

    def train_children(self):
        """Start, together: (c) the training CLI on the reduced smollm
        with --deterministic, with a failure injected at step 12 and
        without (checkpoints every 5 steps); (e) the CLI for 20 steps and
        the e2e example.  Returns {name: (argv, expected text, Popen)}."""
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        train = ["repro_torch.launch.train", "--arch", "smollm-135m",
                 "--reduced"]
        crash = train + ["--steps", "15", "--ckpt-every", "5",
                         "--deterministic"]
        runs = {"crash": (crash + ["--crash-at", "12"], "restarts=1"),
                "no_crash": (crash, "restarts=0"),
                "cli": (train + ["--steps", "20"], "final loss"),
                "e2e_train": (["repro_torch.examples.e2e_train"],
                              "trained 300 steps on cuda")}
        return {name: (argv, want, subprocess.Popen(
            [sys.executable, "-m", *argv], env=env, cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
            for name, (argv, want) in runs.items()}

    def train_children_check(self, procs):
        """Wait for the children of `train_children`: each exits 0 and
        prints what it prints on success, and the crashed run's final
        parameters equal the uninterrupted run's bit for bit."""
        t0 = time.perf_counter()
        out, failed = {}, []
        for name, (argv, want, p) in procs.items():
            try:
                stdout, stderr = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
            lines = stdout.strip().splitlines()
            out[name] = dict(seconds=time.perf_counter() - t0,
                             rc=p.returncode, stdout=lines[-3:])
            log(f"{' '.join(argv)}: rc {p.returncode}, {lines[-3:]}")
            if p.returncode != 0 or want not in stdout:
                failed.append(f"{' '.join(argv)}: rc {p.returncode}\n"
                              f"{stdout[-2000:]}\n{stderr[-2000:]}")
            digest = [x for x in lines if x.startswith("params sha256")]
            out[name]["digest"] = digest[0].split()[2] if digest else None
        if failed:
            raise AssertionError("\n".join(failed))
        if out["crash"]["digest"] != out["no_crash"]["digest"]:
            raise AssertionError(
                "a crash at step 12 and its restart from step 10 ended "
                "with other parameters than an uninterrupted run: "
                f"{out['crash']['digest']} != {out['no_crash']['digest']}")
        log("crash at step 12 and restart on the card: final parameters "
            f"equal bit for bit ({out['crash']['digest'][:16]}...)")
        return out

    def train_full(self, C):
        """(b) smollm-135m at its published width and depth trained by
        `Trainer`, its last checkpoint restored bit for bit; (d) its step
        timed (module docstring)."""
        import tempfile
        torch = self.torch
        from repro_torch.checkpoint import ckpt as CK
        from repro_torch.data.synthetic import DataConfig
        from repro_torch.optim import adamw
        from repro_torch.train.trainer import Trainer, TrainerConfig
        arch, b, s = TRAIN_FULL
        cfg = C.get_config(arch)
        ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=2)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            tr = Trainer(cfg, ocfg, TrainerConfig(
                steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=d,
                log_every=1), dcfg, device=self.dev)
            st = tr.run()
            train_s = time.perf_counter() - t0
            tree, extra = CK.restore(d, device=self.dev)
        losses = st.losses
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite,
                                                     losses)):
            raise AssertionError(f"{arch}: losses {losses}")
        if not statistics.mean(losses[-3:]) < losses[0]:
            raise AssertionError(f"{arch}: the loss did not fall: {losses}")
        if extra != {"next_step": TRAIN_STEPS}:
            raise AssertionError(f"{arch}: checkpoint extra {extra}")
        want = {"params": dict(tr.model.named_parameters()), "opt": tr.opt}
        got_d, want_d = CK.digest(tree), CK.digest(want)
        if got_d != want_d:
            raise AssertionError(f"{arch}: the restored checkpoint differs "
                                 "from the trained state")
        params = list(tr.model.parameters())
        rec = dict(layers=cfg.n_layers, d_model=cfg.d_model,
                   dtype=cfg.dtype, remat=cfg.remat, batch=f"{b} x {s}",
                   n_params=sum(p.numel() for p in params),
                   losses=losses, restarts=st.restarts,
                   trainer_s=train_s, checkpoint_restored="bit for bit",
                   checkpoint_sha256=got_d)
        del tree
        rec.update(self.train_timing(tr, cfg, ocfg, b, s))
        log(f"lm_train {arch} ({cfg.n_layers} layers, {rec['n_params']:,} "
            f"params, bf16, batch {b} x {s}): {json.dumps(rec)}")
        del tr
        torch.cuda.empty_cache()
        return rec

    def train_timing(self, tr, cfg, ocfg, b, s):
        """(d): the train step on the trained model, TRAIN_WARMUP steps,
        then TRAIN_TIMED steps each timed with CUDA events (median), the
        busy share over 2 steps (torch.profiler), peak memory, and the
        bound (`train_bound`)."""
        torch = self.torch
        from repro_torch.train.step import make_train_step
        step = make_train_step(cfg, ocfg)
        state = {"model": tr.model, "opt": tr.opt, "i": TRAIN_STEPS}

        def one():
            batch = tr.batch(state["i"])
            state["i"] += 1
            state["model"], state["opt"], m = step(state["model"],
                                                   state["opt"], batch)
            return m["loss"]

        for _ in range(TRAIN_WARMUP):
            one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(TRAIN_TIMED):
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            loss = one()
            e.record()
            e.synchronize()
            ms.append(a.elapsed_time(e))
            if not torch.isfinite(loss):
                raise AssertionError(f"non-finite loss {loss.item()}")
        peak = torch.cuda.max_memory_allocated()
        prof = self.device_share(lambda: (one(), one()))
        step_ms = statistics.median(ms)
        rec = dict(step_ms=step_ms, step_ms_all=ms,
                   tokens_s=b * s / step_ms * 1e3,
                   busy_share=prof["device_busy_share"],
                   device_ms_per_step=None if prof["device_ms"] is None
                   else prof["device_ms"] / 2,
                   peak_bytes=peak)
        rec.update(self.train_bound(tr.model, cfg, b, s))
        return rec

    def train_bound(self, model, cfg, b, s):
        """The least time the card could take for one step (989 TFLOP/s
        bf16, 3.35 TB/s: `roofline.flop_bound`): 6 N per token for the
        forward and backward products plus 2 N for remat's second
        forward (N = cfg.n_params()), the causal attention (half the
        square, 2 B S (S + 1) H hd a layer forward) four times (forward,
        its recompute, a backward of twice the forward); the bytes of
        AdamW's pass (each parameter read and written, its float32
        gradient read, m and v read and written)."""
        from repro_torch.models import transformer as T
        n = cfg.n_params()
        n_attn = sum(1 for mixer, _ in T.layer_slots(cfg) if mixer == "attn")
        attn = 2 * n_attn * b * s * (s + 1) * cfg.n_heads * cfg.head_dim
        flops = (8 if cfg.remat else 6) * n * b * s \
            + (4 if cfg.remat else 3) * attn
        nbytes = 0
        for p in model.parameters():
            nbytes += p.numel() * (2 * p.element_size() + 4 + 4 * 4)
        bound, by = self.RL.flop_bound(flops, nbytes)
        return dict(bound_flops=flops, bound_bytes=nbytes,
                    bound_ms=bound * 1e3, bound_by=by, cfg_n_params=n)

    # -- phase 11: LM distributed training ---------------------------------

    def lm_dist(self):
        """The distributed LM path (module docstring, phase 11): the child
        processes of (c) first, then the ranks of (a) and (b), then (a)'s
        single-process check and (d)."""
        import tempfile
        rep = self.report["lm_dist"] = {"seconds": {}}
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            rep["cli"] = self.dist_children_check(self.dist_children(d))
        rep["seconds"]["cli"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["ranks"] = self.dist_ranks()
        rep["seconds"]["ranks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["single"] = self.dist_single(rep["ranks"])
        rep["seconds"]["single"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["estimate"] = self.dist_estimate()
        rep["seconds"]["estimate"] = time.perf_counter() - t0
        log(f"lm_dist seconds: {json.dumps(rep['seconds'])}")

    def dist_children(self, tmp):
        """Start, together: the dry run of each DIST_DRYRUN cell into tmp,
        and the reduced training CLI (--deterministic) with and without
        --mesh.  Returns {name: (argv, expected text, Popen)}."""
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        runs = {}
        for arch, shape, mesh in DIST_DRYRUN:
            runs[f"dryrun_{arch}_{shape}"] = (
                ["repro_torch.launch.dryrun", "--arch", arch, "--shape",
                 shape, "--mesh", mesh, "--out", tmp], "1 ok, 0 skipped")
        train = ["repro_torch.launch.train", "--arch", "smollm-135m",
                 "--reduced", "--steps", "10", "--deterministic"]
        runs["train_mesh"] = (train + ["--mesh"], "params sha256")
        runs["train"] = (train, "params sha256")
        procs = {name: (argv, want, subprocess.Popen(
            [sys.executable, "-m", *argv], env=env, cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
            for name, (argv, want) in runs.items()}
        return procs, tmp

    def dist_children_check(self, started):
        """Wait for `dist_children`: each exits 0; each dry-run record is
        ok with its peak under 80 GB and three roofline terms > 0; --mesh
        leaves the sha256 as it is."""
        procs, tmp = started
        t0 = time.perf_counter()
        out, failed = {}, []
        for name, (argv, want, p) in procs.items():
            try:
                stdout, stderr = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
            lines = stdout.strip().splitlines()
            out[name] = dict(seconds=time.perf_counter() - t0,
                             rc=p.returncode, stdout=lines[-2:])
            if p.returncode != 0 or want not in stdout:
                failed.append(f"{' '.join(argv)}: rc {p.returncode}\n"
                              f"{stdout[-2000:]}\n{stderr[-2000:]}")
            digest = [x for x in lines if x.startswith("params sha256")]
            out[name]["digest"] = digest[0].split()[2] if digest else None
        if failed:
            raise AssertionError("\n".join(failed))
        for arch, shape, mesh in DIST_DRYRUN:
            path = Path(tmp) / f"{arch}__{shape}__{mesh}.json"
            rec = json.loads(path.read_text())
            rl, mem = rec["roofline"], rec["memory"]
            keep = {k: rl[k] for k in ("compute_s", "memory_s",
                                       "collective_s", "dot_flops", "bytes",
                                       "wire_bytes", "bottleneck",
                                       "per_kind")}
            keep.update(peak_bytes_est=mem["peak_bytes_est"],
                        argument_bytes=mem["argument_bytes"],
                        useful_ratio=rec["useful_ratio"],
                        trip_counts=rec["trip_counts"],
                        walk_s=rec["walk_s"], status=rec["status"])
            out[f"dryrun_{arch}_{shape}"]["record"] = keep
            log(f"dry run {arch} {shape} {mesh}: {json.dumps(keep)}")
            if rec["status"] != "ok" or mem["peak_bytes_est"] >= 80e9 \
                    or min(rl["compute_s"], rl["memory_s"],
                           rl["collective_s"]) <= 0:
                raise AssertionError(f"dry run {arch} {shape} {mesh}: {rec}")
        if out["train_mesh"]["digest"] != out["train"]["digest"]:
            raise AssertionError(
                "--mesh changed the trained parameters: "
                f"{out['train_mesh']['digest']} != {out['train']['digest']}")
        log("launch.train --mesh on the card: final parameters equal bit "
            f"for bit ({out['train']['digest'][:16]}...)")
        return out

    def dist_ranks(self):
        """(a) and (b) on DIST_RANKS spawned ranks; the losses and the
        pipeline checked, the step, collective and pipeline times."""
        import socket
        import tempfile
        torch = self.torch
        torch.cuda.empty_cache()
        arch, b, s = DIST_FULL
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        ctx = multiprocessing.get_context("spawn")
        with tempfile.TemporaryDirectory() as d:
            procs = [ctx.Process(target=dist_worker, args=(
                r, DIST_RANKS, port, d, arch, b, s, DIST_STEPS, PIPE_MICRO,
                TRAIN_LR)) for r in range(DIST_RANKS)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=600)
            if any(p.exitcode != 0 for p in procs):
                for p in procs:
                    p.kill()
                raise AssertionError("the ranks exited with "
                                     f"{[p.exitcode for p in procs]}")
            ranks = [json.loads((Path(d) / f"rank{r}.json").read_text())
                     for r in range(DIST_RANKS)]
        r0 = ranks[0]
        log(f"lm_dist ranks: {json.dumps(ranks)}")
        for way in ("compressed", "plain"):
            ls = [r[way]["losses"] for r in ranks]
            if any(x != ls[0] for x in ls):
                raise AssertionError(f"{way}: the ranks' losses differ {ls}")
            head = ls[0][:DIST_FALLING + 1]
            if not all(map(math.isfinite, ls[0])) or \
                    not all(b < a for a, b in zip(head, head[1:])) or \
                    not ls[0][-1] < ls[0][0]:
                raise AssertionError(f"{way}: losses {ls[0]}")
        gaps = [c - u for c, u in zip(r0["compressed"]["losses"],
                                      r0["plain"]["losses"])]
        last = abs(gaps[-1])
        if not last < DIST_TOL_LAST:
            raise AssertionError(f"the last losses differ by {last} "
                                 f"(gaps {gaps})")
        ex = [r["exchange"] for r in ranks]
        if not max(e["worst_steps"] for e in ex) <= 0.5 * (1 + 1e-5):
            raise AssertionError(f"int8 exchange against the float32 mean "
                                 f"past half a quantization step: {ex}")
        pipe = r0["pipeline"]
        if not (pipe["within"] and pipe["finite"]):
            raise AssertionError(f"pipelined forward against the "
                                 f"sequential layers: {pipe}")
        summary_grad = pipe_grad_check(ranks)
        summary = dict(backend=r0["backend"], devices=[r["device"]
                                                       for r in ranks],
                       last_loss_diff=last, gaps=gaps, exchange=ex,
                       card=card_line())
        for way in ("compressed", "plain"):
            w = r0[way]
            steady = slice(1, None)              # the first step warms up
            summary[way] = dict(
                losses=w["losses"],
                step_ms=statistics.median(w["step_ms"][steady]),
                collective_ms=statistics.median(w["collective_ms"][steady]),
                bytes_per_step=w["bytes"][-1], calls_per_step=w["calls"][-1],
                tokens_s=b * s / statistics.median(w["step_ms"][steady])
                * 1e3, peak_bytes=max(r[way]["peak_bytes"] for r in ranks))
        summary["pipeline"] = dict(
            pipeline_ms=statistics.median(pipe["pipeline_ms"]),
            sequential_ms=pipe["sequential_ms"],
            max_abs_err=pipe["max_abs_err"], ref_max=pipe["ref_max"],
            stages=DIST_RANKS, layers_per_stage=pipe["layers_per_stage"],
            microbatches=PIPE_MICRO)
        summary["pipe_grad"] = summary_grad
        log(f"lm_dist {arch} over {DIST_RANKS} ranks ({r0['backend']}, "
            f"{summary['devices']}), batch {b} x {s}: {json.dumps(summary)}")
        return summary

    def dist_single(self, ranks):
        """(a)'s check: the uncompressed first two losses against one
        process's `make_train_step` on the global batch, on the card."""
        torch = self.torch
        from repro_torch import configs as C
        from repro_torch.data.synthetic import DataConfig, SyntheticStream
        from repro_torch.models import transformer as T
        from repro_torch.optim import adamw
        from repro_torch.train.step import make_train_step
        arch, b, s = DIST_FULL
        cfg = C.get_config(arch)
        ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=2)
        model = T.init_params(cfg, 0, self.dev)
        stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=s,
                                            global_batch=b))
        step = make_train_step(cfg, ocfg)
        opt = adamw.init_state(dict(model.named_parameters()), ocfg)
        want = []
        for i in range(2):
            batch = {k: torch.from_numpy(v).to(self.dev, torch.long)
                     for k, v in stream.batch(i).items()}
            model, opt, metrics = step(model, opt, batch)
            want.append(float(metrics["loss"]))
        got = ranks["plain"]["losses"][:2]
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        log(f"lm_dist: uncompressed DDP losses {got} against one "
            f"process's {want} (relative {rel}, limit {LM_TOL_BF16})")
        if not max(rel) <= LM_TOL_BF16:
            raise AssertionError(f"DDP losses {got} against {want}")
        del model, opt
        torch.cuda.empty_cache()
        return dict(ddp_losses=got, single_losses=want, rel=rel)

    def dist_estimate(self):
        """(d): the dry run's one-card estimate of phase 10's step (a 1 x 1
        mesh, batch 8 x 2,048) beside phase 10's measured step and
        `train_bound`: a cross-check of the walk's products, not a
        gate."""
        from repro_torch.configs import ShapeCell
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import abstract_mesh
        arch, b, s = TRAIN_FULL
        shape = ShapeCell(f"train_{b}x{s}", s, b, "train")
        rec = D.lower_cell(arch, shape.name, False, shape=shape,
                           mesh=abstract_mesh((1, 1), ("data", "model")))
        rl = rec["roofline"]
        full = self.report["lm_train"]["full"]
        est = dict(dot_flops=rl["dot_flops"], bytes=rl["bytes"],
                   compute_ms=rl["compute_s"] * 1e3,
                   memory_ms=rl["memory_s"] * 1e3,
                   estimate_ms=max(rl["compute_s"], rl["memory_s"]) * 1e3,
                   temp_bytes=rec["memory"]["temp_bytes"],
                   peak_bytes_est=rec["memory"]["peak_bytes_est"],
                   walk_s=rec["walk_s"],
                   phase10_step_ms=full["step_ms"],
                   phase10_peak_bytes=full["peak_bytes"],
                   train_bound_ms=full["bound_ms"],
                   train_bound_flops=full["bound_flops"],
                   flops_vs_bound=rl["dot_flops"] / full["bound_flops"])
        log(f"lm_dist: the dry run's one-card estimate of phase 10's step: "
            f"{json.dumps(est)}")
        return est

    def kernel_line(self, launches):
        """One entry per kernel.  The times and the bound are sums over
        the launches of one divmod_batch at 2^15 bits, batch 256 (for
        mul_batch and mul_pairs: their q*v product there, with the
        2^18 x 32 q*v product under at_2p18; for barrett: one
        reduce_shared launch at the 2^15-bit modulus, 256 lanes; powdiff
        and update add their full-window launch of each division cell
        under full_window).  ms is
        the profiler's device time (CUDA events around the wrapper call
        where the profiler saw nothing; ms_source says which), event_ms
        the events' time with the wrapper's host cost.  mul_pairs'
        library_ms is the float64 grouped conv1d of its column sums
        (`library_pairs`), with cuDNN where that is exact."""
        out = []
        for name, (src, tpu) in KERNELS.items():
            a = self.agg[name]
            bms, by = self.bound(a["products"], a["bytes"])
            dev = a["device_ms"] is not None
            e = dict(name=name, route="cuda", source=src, replaces=tpu,
                     launches=launches.get(name, 0),
                     max_abs_err=self.err[name],
                     ms=a["device_ms"] if dev else a["event_ms"],
                     plain_ms=a["plain_ms"], bound_ms=bms, bound_by=by,
                     library_ms=a.get("library_ms"), event_ms=a["event_ms"],
                     ms_source=a.get("ms_source", "profiler" if dev
                                     else "cuda_events"),
                     shape=a.get("shape",
                                 "one divmod_batch, 2^15 bits, batch 256"))
            n = a.get("launches", 1)
            e["ms_per_launch"] = e["ms"] / n
            e["bound_per_launch"] = bms / n
            if "cluster" in a:           # the cluster size this run used
                e["cluster"] = a["cluster"]
            if name in GRID_TWINS:
                e["also_replaces"] = GRID_TWINS[name]
            for extra in ("at_2p18", "call_device_ms", "call_busy_share",
                          "library", "rate_per_sm", "full_window", "cells"):
                if extra in a:
                    e[extra] = a[extra]
            out.append(e)
        return out


if __name__ == "__main__":
    sys.exit(main())
