"""The "bucket" entry: division batches already on the device through
one bucket executable (`serving/batching.py:Executable` over
`core/shinv.py:divmod_batch`, the object the division service builds
per bucket).

Mix parameters: `batch` lanes a call (default: the configuration's
`instances`); `pool_batches` distinct batches,
cycled in the seed's order; `loop` "ahead" (no synchronise until the
window ends, at most `in_flight` calls queued on the device) or
"closed" (each call's answers copied to the host before the next
call); `check_calls` calls kept by reservoir and `check_lanes` lanes of
each, drawn from the seed, compared with the reference;
`trace_seconds`, the traced window."""

from __future__ import annotations

import sys
import time
from collections import deque
from contextlib import nullcontext
from functools import partial

from bench.harness import base
from bench.harness import traffic as TF
from bench.ref import reference as REF
from bench.yardstick import costmodel as Y


class Runner(base.Runner):
    def setup(self, mark_setup):
        from repro_torch.core import shinv as S
        from repro_torch.serving import batching as BT
        torch, cfg, tr = self.torch, self.config, self.traffic
        self.m = cfg["m_limbs"]
        self.batch = tr.get("batch", cfg["instances"])
        self.u, self.v, self.lu, self.lv = TF.division_pool(
            torch, cfg, tr["pool_batches"], self.batch, self.seed,
            self.device)
        self.order = TF.call_order(tr["pool_batches"], self.seed)
        self.sync()
        self.lap("operands on the device")
        fill_u = torch.zeros(self.batch, self.m, dtype=torch.int32,
                             device=self.device)
        fill_v = fill_u.clone()
        fill_v[:, 0] = 1
        impl = cfg["impl"]
        self.exe = BT.Executable(partial(S.divmod_batch, impl=impl),
                                 (fill_u, fill_v), BT.kernel_plan(impl))
        del fill_u, fill_v
        self.lap("bucket executable (build, warm-up, capture)")
        self.laps.append(("of which capture", self.exe.capture_seconds))
        self.laps.append(("of which instantiate",
                          self.exe.instantiate_seconds))
        self.run.port_kernels = {f"{k}_kernel" for k in self.exe.launches}
        for b in self.order[:2]:                     # warm replays
            self.exe(self.u[b], self.v[b])
        self.sync()
        self.lap("two replays")
        self.mark = mark_setup

    def window(self, seconds: float, profiled: bool):
        from repro_torch.kernels import build
        from repro_torch.obs import telemetry as T
        torch, run, tr = self.torch, self.run, self.traffic
        closed = tr["loop"] == "closed"
        in_flight = tr.get("in_flight", 0)
        keep_n, lanes_n = tr["check_calls"], tr["check_lanes"]
        pick = TF.rng(self.seed, 6)
        self.kept: list = []
        n_pool = len(self.order)
        before = build.launch_counts()
        marks: list = []           # an event after each call: the log
                                   # shows how steady the device was
        span = (lambda name: torch.profiler.record_function(name)) \
            if profiled else (lambda name: nullcontext())

        def body():
            calls, t0 = 0, time.perf_counter()
            end = t0 + seconds
            queued: deque = deque()
            if self.cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            while time.perf_counter() < end:
                if in_flight and len(queued) >= in_flight:
                    with span("bench/wait"):
                        queued.popleft().synchronize()
                b = int(self.order[calls % n_pool])
                with span("bench/dispatch"):
                    q, r = self.exe(self.u[b], self.v[b])
                if self.cuda:
                    marks.append(torch.cuda.Event(enable_timing=True))
                    marks[-1].record()
                    queued.append(marks[-1])
                if closed:
                    with span("bench/copy_out"):
                        q, r = q.cpu(), r.cpu()
                # reservoir sample of the calls whose lanes are checked
                j = len(self.kept) if len(self.kept) < keep_n \
                    else int(pick.integers(0, calls + 1))
                if j < keep_n:
                    idx = sorted(pick.choice(self.batch, lanes_n,
                                             replace=False).tolist())
                    at = torch.tensor(idx, device=q.device)
                    kept = (b, idx, q[at], r[at])
                    if j == len(self.kept):
                        self.kept.append(kept)
                    else:
                        self.kept[j] = kept
                del q, r
                calls += 1
            self.sync()
            run.window_s = time.perf_counter() - t0
            run.calls = calls

        self.mark()
        if profiled:
            T.set_profiling(True)
            run.trace = base.profiled(torch, body)
            T.set_profiling(False)
        else:
            body()
        if len(marks) > 2:
            ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
            print(f"bench: device ms a call over {len(ms)} calls: min "
                  f"{min(ms):.4f} median {sorted(ms)[len(ms) // 2]:.4f} "
                  f"max {max(ms):.4f}; first {[round(x, 2) for x in ms[:4]]}"
                  f" last {[round(x, 2) for x in ms[-4:]]}", file=sys.stderr)
        after = build.launch_counts()
        run.launches = {k: after.get(k, 0) - before.get(k, 0)
                        for k in after if after.get(k, 0) != before.get(k, 0)}
        run.done = run.attempted = run.calls * self.batch
        sent = [int(self.order[i % n_pool]) for i in range(run.calls)]
        per_batch = [Y.divmod_needed(list(zip(self.lu[b].tolist(),
                                              self.lv[b].tolist())), self.m)
                     for b in range(n_pool)] if profiled else None
        run.work = (sum(per_batch[b][0] for b in sent),
                    sum(per_batch[b][1] for b in sent)) if profiled else None

    def release(self):
        """The kept lanes, their operands with them, to the host; the
        program's state freed."""
        self.kept = [(REF.ints_from_limbs(self.u[b][idx].cpu().numpy()),
                      REF.ints_from_limbs(self.v[b][idx].cpu().numpy()),
                      REF.ints_from_limbs(q.cpu().numpy()),
                      REF.ints_from_limbs(r.cpu().numpy()))
                     for b, idx, q, r in self.kept]
        del self.exe, self.u, self.v

    def control(self):
        """The reference in the program's place for every kept lane:
        the quotient before its final correction."""
        kept = []
        for us, vs, _, _ in self.kept:
            qr = [REF.divmod_uncorrected(u, v) for u, v in zip(us, vs)]
            kept.append((us, vs, [q for q, _ in qr], [r for _, r in qr]))
        self.kept = kept

    def check(self) -> dict:
        wrong = checked = 0
        for us, vs, qs, rs in self.kept:
            wrong += REF.wrong_divisions(us, vs, qs, rs)
            checked += len(us)
        return {"wrong_divisions": (wrong, 0),
                "unchecked_calls": (self.traffic["check_calls"]
                                    - len(self.kept), 0),
                "_checked_divisions": checked}
