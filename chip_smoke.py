#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card (nvidia-smi name and power limit);
  2. build the four kernels from src/repro_torch/kernels/csrc with nvcc;
  3. every kernel against its plain PyTorch version on the card, bit for
     bit, at the main path's shapes: divmod_batch at 2^15..2^18 bits with
     each Refine step and the finalization run through kernel AND plain
     version on the same inputs, synthetic adversarial Refine states at
     the 2^15-bit windows, and the standalone product at 2^15 and 2^18
     bits;
  4. the main path: divmod_batch at 2^15/2^16/2^17/2^18 bits (batches
     256/128/64/32), every lane checked against Python divmod and on the
     card as q*v + r == u, with exactly 2*refine_iters(M) + 1 fused
     launches per division, then the division service answering three
     requests (one split across buckets);
  5. timing with CUDA events (median of 5 after a warm-up): each kernel
     at each window it runs at, divmod_batch per precision.

The kernel launch counters are set to 0 just before phase 4 and read
just after it.  Details go to chiprun_out/chip_smoke.json.  The last
line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launches, times and bounds.  Exits non-zero without
a result when there is no CUDA device or no src/repro_torch beside it.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PRECISIONS = ((2 ** 15, 256), (2 ** 16, 128), (2 ** 17, 64), (2 ** 18, 32))
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).  A
# 16x16-bit limb product is 4 int8 sub-digit MACs = 8 int8 operations.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
OPS_PER_LIMB_PRODUCT = 8
KERNELS = {
    "mul_batch": ("src/repro_torch/kernels/csrc/mul.cu",
                  "src/repro/kernels/bigmul.py:323"),
    "powdiff": ("src/repro_torch/kernels/csrc/step.cu",
                "src/repro/kernels/fused.py:441"),
    "update": ("src/repro_torch/kernels/csrc/step.cu",
               "src/repro/kernels/fused.py:454"),
    "correct": ("src/repro_torch/kernels/csrc/correct.cu",
                "src/repro/kernels/fused.py:468"),
}
GRID_TWINS = {"powdiff": "src/repro/kernels/fused.py:748",
              "update": "src/repro/kernels/fused.py:781",
              "correct": "src/repro/kernels/fused.py:810"}


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
    Smoke(torch, build).run()
    return 0


class Smoke:
    def __init__(self, torch, build):
        from repro_torch.core import arith, bigint, shinv
        from repro_torch.kernels import fused, ops
        from repro_torch.obs import costmodel
        from repro_torch.serving.bigint_service import BigintDivisionService
        self.torch, self.build = torch, build
        self.A, self.bi, self.S = arith, bigint, shinv
        self.F, self.K, self.CM = fused, ops, costmodel
        self.Service = BigintDivisionService
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
        self.phase("kernels_vs_plain", self.check_kernels)
        self.build.reset_launch_counts()
        self.phase("main_path", self.main_path)
        launches = self.build.launch_counts()
        log(f"main-path launches: {launches}")
        for k in KERNELS:
            if launches.get(k, 0) < 1:
                raise AssertionError(f"kernel {k} never launched on the "
                                     f"main path")
        self.phase("timing", self.timing)
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

        def step(v, w, *, h, m, l, s, active, g, win):
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

        def correct(u, v, si, *, h):
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

    # -- phase 5: timing -----------------------------------------------------

    @staticmethod
    def bound(ops_products, nbytes):
        ops = OPS_PER_LIMB_PRODUCT * ops_products / PEAK_INT8_OPS
        mem = nbytes / PEAK_BYTES
        return max(ops, mem) * 1e3, "operations" if ops >= mem else "bytes"

    def timing(self):
        """Per precision: each kernel launch of the recorded divmod_batch
        (every Refine window, the finalization) and the q*v product,
        timed with CUDA events around the wrapper call (host cost
        included) and by the profiler on the device; the plain versions
        at 2^15 bits; divmod_batch end to end with its device busy
        share."""
        F, K, S = self.F, self.K, self.S
        rows, agg = [], {}
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
                # bytes the functions need: powdiff reads win limbs of v
                # (from offset s) and of w, writes x at full width, and
                # moves 4 scalars per lane; update reads win limbs of w
                # and x and writes full width on an active lane, copies
                # w on an inactive one, and reads 4 scalars per lane
                pd_bytes = 4 * batch * (2 * win + fw + 4)
                up_bytes = 4 * (act * (2 * win + fw)
                                + (batch - act) * 2 * fw + 4 * batch)
                items.append((row, "powdiff",
                              lambda a=pd_args, w=win: F.powdiff_cuda(
                                  *a, win=w),
                              lambda a=pd_args, w=win: F.powdiff_reference(
                                  *a, win=w),
                              (batch * win * win, pd_bytes)))
                items.append((row, "update",
                              lambda a=up_args, w=win: F.update_cuda(
                                  *a, win=w),
                              lambda a=up_args, w=win: F.update_reference(
                                  *a, win=w),
                              (act * win * win, up_bytes)))
            c = rec["correct"]
            W = c["u"].shape[1]
            cargs = (c["u"], c["v"], c["si"])
            u, v, q = self.main_inputs[bits]
            m = u.shape[1]
            tail = dict(bits=bits, batch=batch)
            items.append((tail, "correct",
                          lambda: F.correct_cuda(*cargs, h=c["h"]),
                          lambda: F.correct_reference(*cargs, h=c["h"]),
                          (batch * (W * W + W * (W + 1) // 2),
                           4 * batch * (5 * W + 1))))
            items.append((tail, "mul_batch", lambda: K.mul_batch(q, v, m),
                          lambda: K.mul_plain(q, v, m),
                          (batch * m * (m + 1) // 2, 4 * batch * 3 * m)))
            dev = self.device_us([it[2] for it in items])
            for j, (row, name, fn, plain, work) in enumerate(items):
                row[f"{name}_ms"] = self.time_ms(fn)
                row[f"{name}_device_ms"] = dev[j] / 1e3 if dev else None
                row[f"{name}_bound_ms"] = self.bound(*work)[0]
                if first:
                    row[f"{name}_plain_ms"] = self.time_ms(plain)
                    a = agg.setdefault(name, dict(
                        event_ms=0.0, device_ms=0.0 if dev else None,
                        plain_ms=0.0, products=0, bytes=0))
                    a["event_ms"] += row[f"{name}_ms"]
                    if dev:
                        a["device_ms"] += row[f"{name}_device_ms"]
                    a["plain_ms"] += row[f"{name}_plain_ms"]
                    a["products"] += work[0]
                    a["bytes"] += work[1]
            for row in dict((id(it[0]), it[0]) for it in items).values():
                if row is tail:
                    dm = self.time_ms(lambda: S.divmod_batch(u, v))
                    row.update(divmod_ms=dm,
                               divisions_per_s=batch / (dm / 1e3))
                    row.update(self.device_share(
                        lambda: S.divmod_batch(u, v), dm))
                rows.append(row)
                log(json.dumps(row))
        self.report["timing"] = rows
        self.agg = agg

    def device_us(self, calls):
        """Device time (us) of each port kernel the calls launch, in
        launch order (torch.profiler); None where the profiler reports
        a different number of kernels than there are calls."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fn in calls:
                fn()
            self.torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and e.name.split("(")[0].endswith("_kernel")
               and e.name.split("(")[0][:-len("_kernel")] in KERNELS]
        evs.sort(key=lambda e: e.time_range.start)
        if len(evs) != len(calls):
            log(f"profiler saw {len(evs)} kernels for {len(calls)} calls")
            return None
        return [e.time_range.elapsed_us() for e in evs]

    def device_share(self, fn, wall_ms):
        """Device time of one call by kernel name (torch.profiler), and
        the device's busy share of the unprofiled call's time `wall_ms`.
        None where the profiler reports no device time."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            self.torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
                name = e.key.split("(")[0]
                per[name] = dict(us=us, count=e.count)
        total = sum(d["us"] for d in per.values()) / 1e3
        ours = {k: per[k] for k in per if k.endswith("_kernel")
                and k.split("_kernel")[0] in KERNELS}
        return dict(device_ms=total if per else None,
                    device_busy_share=total / wall_ms if per else None,
                    device_by_kernel=ours, device_other_ms=(
                        total - sum(d["us"] for d in ours.values()) / 1e3)
                    if per else None)

    def kernel_line(self, launches):
        """One entry per kernel.  The times and the bound are sums over
        the launches of one divmod_batch at 2^15 bits, batch 256 (for
        mul_batch: its q*v product there).  ms is the profiler's device
        time (CUDA events around the wrapper call where the profiler saw
        nothing; ms_source says which), event_ms the events' time with
        the wrapper's host cost."""
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
                     library_ms=None, event_ms=a["event_ms"],
                     ms_source="profiler" if dev else "cuda_events",
                     shape="one divmod_batch, 2^15 bits, batch 256")
            if name in GRID_TWINS:
                e["also_replaces"] = GRID_TWINS[name]
            out.append(e)
        return out

if __name__ == "__main__":
    sys.exit(main())
