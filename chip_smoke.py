#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card (nvidia-smi name and power limit);
  2. build the six kernels from src/repro_torch/kernels/csrc with nvcc
     (one nvcc per source, all at once, into the git-ignored
     src/repro_torch/kernels/_build/);
  3. every kernel against its plain PyTorch version on the card, bit for
     bit, at the main paths' shapes: divmod_batch at 2^15..2^18 bits with
     each Refine step and the finalization run through kernel AND plain
     version on the same inputs, synthetic adversarial Refine states at
     the 2^15-bit windows, at every cluster size (1/2/4/8 blocks per
     instance) and at a 2^18-bit modulus's W = 32778, the standalone
     product at 2^15 and 2^18 bits;
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
     and on the card as q*v + r == u, with exactly 2*refine_iters(M) + 1
     fused launches per division and the finalization on clusters of
     cluster_size(batch) blocks, then the division service answering
     three requests (one split across buckets);
  4b. a wide division: divmod_batch of 4 lanes at 30,000 limbs under
     cuda_fused (past the ~29,000 limbs the CUDA-core finalization
     staged), exact against Python, with divmod_launches(30000)
     launches;
  4c. the divmod width cap under cuda_fused and cuda_batched, found by
     asking shinv.check_width (the kernel libraries' staging sizes):
     one limb past the cuda_fused cap, divmod_batch and the division
     service's constructor raise ValueError with no launch counted;
  5. the modular-arithmetic path: at 2^15/2^16/2^17-bit moduli the
     Barrett precompute (30/32/34 launches), reduce_shared and
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
     grouped conv1d of the column sums, checked exact.  ptxas registers
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
     divmod_launches(16384) launches, a roofline equal to the sum of
     its launches' terms (obs/roofline.py over the cost model's work),
     its compile seconds and peak memory; the record goes to
     results/dryrun/bigint_div.json and into the report.

The services of phases 4, 5, 5b, 5c, 5d and 7 run through their bucket
graphs; where a phase counts a service call's launches exactly, it
builds the service's graphs first (`profile_bucket`), since a build's
eager warm-up launches too.  Phases 7 and 8 run after 5d, and 7's
timing after 6b.

The kernel launch counters are set to 0 just before each of phases 4,
4b, 4c, 5, 5b, 5c, 5d, 7 and 8 and read just after it.  Details go to
chiprun_out/chip_smoke.json.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, times and bounds.  Exits non-zero
without a result when there is no CUDA device or no src/repro_torch
beside it.  Before it exits, pass or fail, it stops every process it
started (the host pools' workers and multiprocessing's resource
tracker).
"""

from __future__ import annotations

import json
import multiprocessing
import os
import random
import signal
import statistics
import subprocess
import sys
import time
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
}
GRID_TWINS = {"powdiff": "src/repro/kernels/fused.py:748",
              "update": "src/repro/kernels/fused.py:781",
              "correct": "src/repro/kernels/fused.py:810",
              "barrett": "src/repro/kernels/fused.py:854"}
# kernels each main path must launch
PATH_KERNELS = {"division_path": ("mul_batch", "powdiff", "update",
                                  "correct"),
                "wide_division": ("powdiff", "update", "correct"),
                "modarith_path": ("mul_batch", "powdiff", "update",
                                  "barrett"),
                "frontend_path": ("mul_batch", "powdiff", "update",
                                  "correct", "barrett"),
                "pairs_path": ("mul_pairs",),
                "frontend_chaos": ("mul_batch", "powdiff", "update",
                                   "correct"),
                "sharded_path": ("mul_batch", "powdiff", "update",
                                 "correct", "barrett"),
                "dryrun": ("powdiff", "update", "correct")}
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
        m = re.search(r"Function properties for _Z\d+(\w+?_kernel)", line)
        if m:
            name = m.group(1)
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
                         ("dryrun", self.dryrun)):
            self.build.reset_launch_counts()
            self.phase(name, fn)
            got = self.build.launch_counts()
            log(f"{name} launches: {got}")
            for k in PATH_KERNELS[name]:
                if got.get(k, 0) < 1:
                    raise AssertionError(f"kernel {k} never launched on "
                                         f"the {name}")
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            self.report.setdefault("path_launches", {})[name] = got
            if name == "wide_division":
                self.phase("width_cap", self.width_cap)
        self.phase("timing", self.timing)
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

        K.fused_step, K.fused_correct = step, correct
        try:
            yield
        finally:
            K.fused_step, K.fused_correct = orig

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
        # every cluster size, and a 2^18-bit modulus's full window (4
        # lanes, the cluster of the precompute's single lane)
        for batch, fw, win in ((256, full_w, 528), (100, full_w, 528),
                               (64, full_w, 528), (5, full_w, 528),
                               (4, 32778, 32778)):
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
            log(f"powdiff+update synthetic states, win {win}, batch "
                f"{batch}, cluster {cs}: exact")
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
        log(f"kernel-vs-plain comparisons: {self.checked}, max abs err "
            f"{self.err}")
        self.report["checked"] = dict(self.checked)

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
                     for k in ("powdiff", "update", "correct")}
            it = CM.refine_iters(m)
            if (moved != {"powdiff": it, "update": it, "correct": 1}
                    or sum(moved.values()) != CM.divmod_launches(m)):
                raise AssertionError(f"2^{bits.bit_length() - 1} bits: "
                                     f"launches {moved}, expected "
                                     f"{CM.divmod_launches(m)}")
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
                    {"powdiff": it, "update": it, "correct": 1})
        self.expect(f"divmod {m} limbs launch total", sum(got.values()),
                    self.CM.divmod_launches(m))
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
            ctx, n = self.launched(lambda: MA.barrett_precompute(vt))
            self.expect(f"{tag} precompute launches", n,
                        CM.precompute_launches(m))
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
            log(f"{tag}: precompute {CM.precompute_launches(m)} launches, "
                f"reduce_shared and modmul_shared on {batch} lanes "
                f"(1 and 2 launches), every lane exact")
            self.mod_inputs[bits] = dict(L=L, vt=vt, ctx=ctx, x=x, a=a, b=b)
            if bits != MODULI[0][0]:
                continue
            vl = self.tensor(L["vs"][:64], m)
            r, n = self.launched(lambda: MA.reduce_batch(x[:64], vl))
            self.expect(f"{tag} reduce_batch launches", n,
                        CM.precompute_launches(m) + CM.barrett_launches())
            if ints(r) != [xx % vv for xx, vv in zip(L["x"], L["vs"][:64])]:
                raise AssertionError(f"{tag}: reduce_batch inexact")
            p, n = self.launched(lambda: MA.modmul_batch(a[:64], b[:64], vl))
            self.expect(f"{tag} modmul_batch launches", n,
                        CM.precompute_launches(m) + CM.modmul_launches())
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
                    CM.precompute_launches(m))
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
        log(f"{tag}: precompute {CM.precompute_launches(m)} launches, "
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
                CM.divmod_launches(m, impl), plain=lambda: plain[bits],
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
                 CM.precompute_launches(m), batch),
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
                        n * chunks * CM.divmod_launches(M18))
            if list(zip(*got)) != host_map(_divmod, zip(us, vs)):
                raise AssertionError("sharded divmod inexact")
            if got != one.divide(us, vs):
                raise AssertionError("sharded divmod differs from the "
                                     "unsharded service")
            log(f"sharded division 2^18 bits, {rows} rows in {chunks} "
                f"chunk(s) over {n} shards: {k} launches "
                f"({n} x {chunks} x {CM.divmod_launches(M18)}), exact, "
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
                pre = CM.precompute_launches(m) if i < 2 and \
                    op == "reduce" else 0
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
                    CM.divmod_launches(M18))
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
