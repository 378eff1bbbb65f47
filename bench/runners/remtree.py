"""The "remtree" entry: batch GCD's remainder-tree descent through one
bucket executable (`serving/batching.py:Executable` over
`core/remtree.py:descend`): per level, the square of each node, the
hand-off of the parent's remainder and one `divmod_batch`, all levels
in one CUDA graph.

Configuration: `m_limbs` the top level's bucket width, `instances` its
nodes, `levels` the levels below it (level i at m_limbs / 2^i limbs and
instances * 2^i nodes, while the width stays >= 8 limbs), `leaf_bits`
the moduli's size, `impl`.  The leaves are odd, of leaf_bits with the
top bit set, or of the bottom nodes' own width where that is narrower;
the product tree above them is built in set-up with the port's product,
and the remainders above the top level are drawn uniformly below their
node's square.  All from the seed, on the device.

Mix parameters: `pool_batches` distinct trees, cycled in the seed's
order; `loop` "ahead" (no synchronise until the window ends, at most
`in_flight` calls queued); `check_calls` calls kept by reservoir and
`check_lanes` root-to-leaf paths of each, drawn from the seed, whose
every division is compared with the reference; `trace_seconds`, the
traced window."""

from __future__ import annotations

import sys
import time
from collections import deque
from contextlib import nullcontext

from bench.harness import base
from bench.harness import traffic as TF
from bench.ref import reference as REF
from bench.ref import remtree as RREF
from bench.yardstick import costmodel as Y
from bench.yardstick import squares as SQ

MIN_WIDTH = 8          # a level's bucket width: X of at least 2 limbs


def level_shapes(cfg: dict) -> list[tuple[int, int]]:
    """[(bucket width M, nodes)] of each level, top down."""
    out = []
    for i in range(cfg["levels"]):
        m = cfg["m_limbs"] >> i
        if m < MIN_WIDTH or m << i != cfg["m_limbs"]:
            break
        out.append((m, cfg["instances"] << i))
    return out


def _less(torch, a, b):
    """a < b per row of limbs: decided by the highest limb that differs."""
    idx = torch.arange(a.shape[1], device=a.device)
    top = torch.where(a != b, idx, -1).amax(dim=1)
    at = top.clamp(min=0)[:, None]
    return (top >= 0) & (a.gather(1, at) < b.gather(1, at))[:, 0]


def uniform_below(torch, bound, gen):
    """Rows drawn uniformly from [0, bound) for each row of `bound` (> 0):
    limbs up to bound's top limb, the top one below it + 1, redrawn
    where the draw reaches bound (under half the rows a round)."""
    n, m = bound.shape
    dev = bound.device
    idx = torch.arange(m, device=dev)
    top = torch.where(bound != 0, idx, -1).amax(dim=1)
    t = bound.gather(1, top[:, None])[:, 0].long()
    out = torch.empty_like(bound)
    todo = torch.arange(n, device=dev)
    for _ in range(64):
        if not len(todo):
            return out
        k = len(todo)
        r = torch.randint(0, TF.BASE, (k, m), generator=gen, device=dev,
                          dtype=bound.dtype)
        r.masked_fill_(idx[None, :] >= top[todo, None], 0)
        hi = torch.randint(0, 1 << 62, (k,), generator=gen, device=dev,
                           dtype=torch.int64) % (t[todo] + 1)
        r.scatter_(1, top[todo, None], hi[:, None].to(r.dtype))
        out[todo] = r
        todo = todo[~_less(torch, r, bound[todo])]
    raise RuntimeError("uniform_below: rows still at or above the bound")


def _prec(torch, x):
    """Significant limbs of each row, on x's device."""
    idx = torch.arange(1, x.shape[1] + 1, device=x.device)
    return torch.where(x != 0, idx, 0).amax(dim=1)


class Runner(base.Runner):
    def setup(self, mark_setup):
        from repro_torch.core import remtree as RT
        from repro_torch.kernels import ops as K
        from repro_torch.serving import batching as BT
        torch, cfg, tr = self.torch, self.config, self.traffic
        if tr.get("loop", "ahead") != "ahead":
            raise ValueError(f"the remtree runner runs the ahead loop, not "
                             f"{tr['loop']!r}")
        self.shapes = level_shapes(cfg)
        top_m, top_n = self.shapes[0]
        bottom_m, bottom_n = self.shapes[-1]
        impl = cfg["impl"]
        self.leaf = min(cfg["leaf_bits"] // 16, bottom_m // 4)
        widths = {m // 4 for m, _ in self.shapes} | {top_m // 2}
        gen = TF.torch_generator(torch, self.device, self.seed, 9)
        self.trees = []
        for _ in range(tr["pool_batches"]):
            leaves = torch.randint(
                0, TF.BASE, (bottom_n * (bottom_m // 4) // self.leaf,
                             self.leaf),
                generator=gen, device=self.device, dtype=torch.int32)
            leaves[:, 0] |= 1
            leaves[:, -1] |= 1 << 15
            nodes, x = {self.leaf: leaves}, leaves
            while x.shape[1] < top_m // 2:      # the product tree, up
                w = 2 * x.shape[1]
                x = K.mul_batch(x[0::2], x[1::2], w, impl)
                if w in widths:
                    nodes[w] = x
            parent = nodes.pop(top_m // 2)
            r_top = uniform_below(torch, K.mul_batch(parent, parent, top_m,
                                                     impl), gen)
            xs = [nodes[m // 4] for m, _ in self.shapes]
            self.trees.append((r_top, xs, leaves))
            del parent, nodes, x
        self.order = TF.call_order(tr["pool_batches"], self.seed)
        self.sync()
        self.lap("product trees on the device")
        r_top, xs, _ = self.trees[0]
        fill = (torch.zeros_like(r_top), *map(torch.ones_like, xs))
        self.exe = BT.Executable(lambda r, *x: RT.descend(r, x, impl=impl),
                                 fill, BT.kernel_plan(impl))
        del fill
        self.lap("bucket executable (build, warm-up, capture)")
        self.laps.append(("of which capture", self.exe.capture_seconds))
        self.laps.append(("of which instantiate",
                          self.exe.instantiate_seconds))
        self.run.port_kernels = {f"{k}_kernel" for k in self.exe.launches}
        self.lengths = [self._warm(b) for b in range(len(self.trees))]
        # the check draws and gathers its paths on the card: once here,
        # so that those kernels load in set-up, not in the window
        paths = torch.randperm(bottom_n, device=self.device)
        xs[-1][paths[:tr["check_lanes"]] >> 1]
        self.sync()
        if self.cuda:    # set-up's temporaries (the tree, the lengths) out of
            torch.cuda.empty_cache()   # the cache the window allocates from
        self.lap(f"{len(self.trees)} replays")
        self.mark = mark_setup

    def _warm(self, b: int) -> list:
        """One replay of tree b, and each level's (prec(u), prec(X^2),
        prec(X)) per node on the host: what its divisions and squares
        need.  prec(X^2) is 2 prec(X), less one where X's top limb is
        below 2^8 = sqrt(B)."""
        torch = self.torch
        r_top, xs, _ = self.trees[b]
        out = self.exe(r_top, *xs)
        got, u = [], r_top
        for i, x in enumerate(xs):
            px = _prec(torch, x)
            t = x.gather(1, (px - 1).clamp(min=0)[:, None])[:, 0]
            pv = 2 * px - (t < 256).long()
            pu = _prec(torch, u).repeat_interleave(2)
            got.append((pu.tolist(), pv.tolist(), px.tolist()))
            u = out[2 * i + 1]
        return got

    def window(self, seconds: float, profiled: bool):
        from repro_torch.kernels import build
        from repro_torch.obs import telemetry as T
        torch, run, tr = self.torch, self.run, self.traffic
        in_flight = tr.get("in_flight", 0)
        keep_n, paths_n = tr["check_calls"], tr["check_lanes"]
        pick = TF.rng(self.seed, 6)
        gen = TF.torch_generator(torch, self.device, self.seed, 7)
        self.kept: list = []
        n_pool, levels = len(self.order), len(self.shapes)
        bottom_n = self.shapes[-1][1]
        before = build.launch_counts()
        marks: list = []
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
                r_top, xs, _ = self.trees[b]
                with span("bench/dispatch"):
                    out = self.exe(r_top, *xs)
                if self.cuda:
                    marks.append(torch.cuda.Event(enable_timing=True))
                    marks[-1].record()
                    queued.append(marks[-1])
                j = len(self.kept) if len(self.kept) < keep_n \
                    else int(pick.integers(0, calls + 1))
                if j < keep_n:       # paths drawn and gathered on the card:
                    paths = torch.randperm(     # nothing waits for the queue
                        bottom_n, generator=gen, device=self.device)[:paths_n]
                    got = []
                    for i in range(levels):
                        at = paths >> (levels - 1 - i)
                        got.append((at, out[2 * i][at], out[2 * i + 1][at]))
                    kept = (b, got)
                    if j == len(self.kept):
                        self.kept.append(kept)
                    else:
                        self.kept[j] = kept
                del out
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
            st = torch.cuda.memory_stats(self.device)
            print(f"bench: allocator: reserved "
                  f"{st.get('reserved_bytes.all.current', 0)} B (peak "
                  f"{st.get('reserved_bytes.all.peak', 0)} B), "
                  f"{st.get('num_alloc_retries', 0)} retries, "
                  f"{st.get('num_device_alloc', 0)} device allocations, "
                  f"{st.get('num_device_free', 0)} frees", file=sys.stderr)
        after = build.launch_counts()
        run.launches = {k: after.get(k, 0) - before.get(k, 0)
                        for k in after if after.get(k, 0) != before.get(k, 0)}
        run.done = run.attempted = run.calls * sum(n for _, n in self.shapes)
        if profiled:
            per_tree = [self._work(b) for b in range(n_pool)]
            total = [sum(per_tree[int(self.order[i % n_pool])][k]
                         for i in range(run.calls)) for k in range(4)]
            run.work = (total[0] + total[2], total[1] + total[3])
            run.square_work = (total[2], total[3])

    def _work(self, b: int) -> list:
        """[products, bytes] of the divisions, then [products, bytes] of
        the squares, that one descent of tree b needs."""
        out = [0, 0, 0, 0]
        for (m, _), (pu, pv, px) in zip(self.shapes, self.lengths[b]):
            got = Y.divmod_needed(list(zip(pu, pv)), m) \
                + SQ.squares_needed(px, m)
            out = [a + c for a, c in zip(out, got)]
        return out

    def release(self):
        """The kept divisions, and the remainders and leaves above their
        paths, to the host; the program's state freed."""
        torch = self.torch
        top_m = self.shapes[0][0]
        kept = []
        for b, got in self.kept:
            levels = []
            for at, q, r in got:            # each node once, in order
                qr = dict(zip(at.tolist(),
                              zip(REF.ints_from_limbs(q.cpu().numpy()),
                                  REF.ints_from_limbs(r.cpu().numpy()))))
                lanes = sorted(qr)
                levels.append((lanes, [qr[j][0] for j in lanes],
                               [qr[j][1] for j in lanes]))
            r_top, _, leaves = self.trees[b]
            rows = sorted({j >> 1 for j in levels[0][0]})
            per = (top_m // 2) // self.leaf
            at = torch.tensor(rows, device=r_top.device)
            tops = REF.ints_from_limbs(r_top[at].cpu().numpy())
            lv = leaves.reshape(-1, per, self.leaf)[at].cpu().numpy()
            kept.append((
                dict(zip(rows, tops)),
                {p: REF.ints_from_limbs(a) for p, a in zip(rows, lv)},
                levels))
        self.kept = kept
        del self.exe, self.trees

    def control(self):
        """The reference in the program's place for every kept division,
        with one stated guarantee broken: each node divided by X, not
        X^2 (the plain remainder tree's step, R mod X, where batch GCD
        needs R mod X^2), its remainder handed down the same way."""
        kept = []
        for tops, leaves, got in self.kept:
            div = RREF.path_divisions(tops, leaves, [g[0] for g in got],
                                      divisor=lambda x: x)
            levels = [(lanes, [div[(i, j)][0] for j in lanes],
                       [div[(i, j)][1] for j in lanes])
                      for i, (lanes, _, _) in enumerate(got)]
            kept.append((tops, leaves, levels))
        self.kept = kept

    def check(self) -> dict:
        wrong = checked = 0
        for tops, leaves, got in self.kept:
            want = RREF.path_divisions(tops, leaves, [g[0] for g in got])
            for i, (lanes, qs, rs) in enumerate(got):
                wrong += sum(want[(i, j)] != qr
                             for j, qr in zip(lanes, zip(qs, rs),
                                              strict=True))
                checked += len(lanes)
        # a window that ran fewer calls than check_calls checks them all
        keep_n = min(self.traffic["check_calls"], self.run.calls)
        return {"wrong_divisions": (wrong, 0),
                "unchecked_calls": (keep_n - len(self.kept), 0),
                "_checked_divisions": checked}
