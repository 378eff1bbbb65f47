"""Operation-level cost extraction from one run of a function: the
port's counterpart of `repro/utils/hlo_costs.py`.

JAX parses the optimized (post-SPMD) HLO of a compiled program.  The
port has no compiler between the model and the card, so `analyze(fn,
*args)` runs fn once (the dry run runs it on fake tensors: nothing is
allocated) under a `TorchDispatchMode` that sees every aten op it
dispatches, the backward pass's included:

  * products (mm, bmm, addmm, baddbmm; einsum, linear and matmul reach
    them) = 2 * |out| * prod(contracting dims), in `dot_flops`;
    elementwise FLOPs approximated by each other op's output size
    (reported separately, as JAX's fusion-output proxy);
  * bytes = each op's operand and output sizes; a view moves nothing;
    an in-place op writes its first operand, so `copy_` into a slice is
    billed at the window, twice (JAX's dynamic-update-slice rule);
  * collectives by kind (all-reduce / all-gather / reduce-scatter /
    all-to-all / collective-permute) with their group sizes, where a
    real `torch.distributed` collective runs; the dry run adds the ones
    its layout implies (`Costs.add_collective`).

Eager Python loops visit every iteration, so no trip count has to be
parsed.  A loop that the walk runs once and multiplies
(`utils/loops.py:steps`: the Mamba scan, the microbatch loop; the dry
run also scales a repeat unit of layers) records its count in
`trip_counts`.  The walk also follows the bytes of live tensors it saw
allocated (`Costs.peak_bytes`; `relayout` sets a storage's bytes to its
size in another layout).

`roofline_terms` is JAX's pure function with the H100's constants.
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from dataclasses import asdict, dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch.mesh import HOST_CARDS
from repro_torch.utils import loops

# torch.distributed's dispatcher ops by kind (c10d and its functional
# twins)
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "all-gather",
}
_PRODUCTS = ("mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv",
             "dot")
# ops that compute nothing: factories, and copy_ (a slice write)
_NO_FLOPS = ("empty", "empty_like", "empty_strided", "zeros", "zeros_like",
             "ones", "ones_like", "full", "full_like", "new_empty",
             "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor",
             "lift_fresh", "randn", "rand", "normal_", "copy_")
_LOOP_KEY = "op_costs_loop"
_ACTIVE: list = []        # the walks running in this process, innermost last


@dataclass
class Costs:
    dot_flops: float = 0.0
    elem_flops: float = 0.0            # output-size proxy
    bytes_accessed: float = 0.0
    collective_bytes: dict = field(default_factory=dict)   # kind -> bytes
    # (kind, bytes, group size, whether the group leaves its host or None)
    collective_info: list = field(default_factory=list)
    trip_counts: dict = field(default_factory=dict)
    peak_bytes: float = 0.0            # the most live bytes the walk saw

    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def add_collective(self, kind: str, nbytes: float, group: int,
                       crosses=None, mult: float = 1.0) -> None:
        """Bill mult x nbytes of `kind` over a group of `group` members;
        entries of one (kind, group, crosses) are summed into one."""
        self.collective_bytes[kind] = \
            self.collective_bytes.get(kind, 0.0) + mult * nbytes
        for i, (k, size, g, c) in enumerate(self.collective_info):
            if (k, g, c) == (kind, group, crosses):
                self.collective_info[i] = (k, size + mult * nbytes, g, c)
                return
        self.collective_info.append((kind, mult * nbytes, group, crosses))

    def add(self, other: "Costs", mult: float = 1.0) -> None:
        """Add mult x other's counts (not its peak or trip counts)."""
        self.dot_flops += mult * other.dot_flops
        self.elem_flops += mult * other.elem_flops
        self.bytes_accessed += mult * other.bytes_accessed
        for kind, size, g, crosses in other.collective_info:
            self.add_collective(kind, size, g, crosses, mult)

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Costs":
        d = dict(d)
        d["collective_info"] = [tuple(x) for x in d["collective_info"]]
        return cls(**d)


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args) -> float:
    a = [x for x in args if isinstance(x, torch.Tensor)]
    if name in ("mm", "addmm"):
        x, w = a[-2], a[-1]
        return 2.0 * x.shape[0] * w.shape[1] * x.shape[1]
    if name in ("bmm", "baddbmm"):
        x, w = a[-2], a[-1]
        return 2.0 * x.shape[0] * x.shape[1] * w.shape[2] * x.shape[2]
    if name == "addbmm":
        x, w = a[-2], a[-1]
        return 2.0 * x.shape[0] * x.shape[1] * w.shape[2] * x.shape[2]
    if name in ("mv", "addmv"):
        x = a[-2]
        return 2.0 * x.shape[0] * x.shape[1]
    return 2.0 * a[0].numel()                       # dot


def _group_size(args) -> int:
    """The group size of a c10d op: its ProcessGroup argument's."""
    from torch._C._distributed_c10d import ProcessGroup
    for x in args:
        if isinstance(x, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(x).size()
            except RuntimeError:
                continue
    return 0


def _tag(node) -> int:
    """The loop factor of an autograd node (1: made outside every
    collapsed loop)."""
    return node.metadata.get(_LOOP_KEY, 1)


class _Walk(TorchDispatchMode):
    def __init__(self, costs: Costs, mult: float):
        super().__init__()
        self.costs = costs
        self.mult = mult
        self.loop = 1               # the collapsed loops' factor
        # the last tagged node to finish its backward (sequence number)
        # and the factor of the engine's add of each gradient it sent
        # out of its loop (by the gradient's TensorImpl)
        self.sums: tuple = (None, {})
        self.live = 0
        self.refs: dict = {}        # storage -> [bytes, tensors holding it]

    def factor(self, name: str = "", args=()) -> float:
        """The multiplier of the running op: the walk's, times the
        collapsed loop's it belongs to (a backward op: its node's; the
        engine's add of a gradient that a tagged node sent out of its
        loop: the receiving node's, `_TagLoop`)."""
        node = torch._C._current_autograd_node()
        loop = 1
        if node is not None:
            loop = _tag(node)
            if name == "add" and len(args) > 1 \
                    and self.sums[0] == node._sequence_nr():
                loop = self.sums[1].get(args[1]._cdata, loop)
        return self.mult * max(self.loop, loop)

    def _free(self, key) -> None:
        ent = self.refs.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self.refs[key]

    def _hold(self, t: torch.Tensor, new: bool) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        ent = self.refs.get(key)
        if ent is None:
            if not new:
                return              # a view of something allocated before
            ent = self.refs[key] = [st.nbytes(), 0]
            self.live += ent[0]
            self.costs.peak_bytes = max(self.costs.peak_bytes, self.live)
        ent[1] += 1
        weakref.finalize(t, self._free, key)

    def relayout(self, t: torch.Tensor, nbytes: int) -> None:
        ent = self.refs.get(t.untyped_storage()._cdata)
        if ent is not None:
            self.live += nbytes - ent[0]
            ent[0] = nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._opname
        if ns == "prim":
            return out
        m = self.factor(name, args)
        c = self.costs
        outs = _tensors(out)
        if ns in ("c10d", "_c10d_functional"):
            kind = _C10D_KINDS.get(name)
            if kind is not None:
                size = max(sum(_nbytes(t) for t in _tensors(args)),
                           sum(_nbytes(t) for t in outs))
                c.add_collective(kind, size, _group_size(args), None, m)
            return out
        if func.is_view:
            for t in outs:
                self._hold(t, new=False)
            return out
        ins = _tensors((args, kwargs))
        inplace = any(a.alias_info is not None and a.alias_info.is_write
                      for a in func._schema.arguments)
        if name in _PRODUCTS:
            c.dot_flops += m * _dot_flops(name, args)
        elif name not in _NO_FLOPS:
            c.elem_flops += m * sum(t.numel() for t in outs)
        moved = sum(_nbytes(t) for t in ins)
        if not inplace:
            moved += sum(_nbytes(t) for t in outs)
            for t in outs:
                self._hold(t, new=True)
        c.bytes_accessed += m * moved
        return out


class _TagLoop(torch.overrides.TorchFunctionMode):
    """Marks the autograd nodes made inside a collapsed loop with the
    walk's loop factor there (nested loops' counts multiplied), so the
    walk multiplies their backward ops too: every node made since the
    loop began (by sequence number) that a function's outputs reach, the
    ones a composite function (einsum) makes inside itself included.

    The whole loop's backward also sums the gradients that its n
    iterations send to a tensor from outside it (a slice `x[:, t]` of a
    stream, a weight): the autograd engine adds each one into the
    tensor's gradient, n - 1 additions that the walk of one iteration
    never sees.  A tagged node's post-hook bills them, each as the
    engine's out-of-place add (both operands read, the sum written), at
    the node's factor less the receiving node's; where the walk's one
    gradient is not the first to arrive, the engine's own add of it is
    counted at the receiving node's factor (`_Walk.sums`), so the order
    in which the engine runs the nodes does not matter.  A backward run
    inside the loop (the microbatch loop's) sees one iteration's
    gradients, as the whole loop's does: it bills none past the loop it
    runs in.  A carry whose first value has no gradient (the zeros a
    scan starts from) makes the first iteration unlike the others; the
    walk counts the first."""

    def __init__(self, walk: "_Walk", n: int):
        super().__init__()
        self.walk, self.n = walk, n
        self.start = torch._C._autograd._get_sequence_nr()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        todo = [t.grad_fn for t in _tensors(out)]
        while todo:
            node = todo.pop()
            if node is None or hasattr(node, "variable") \
                    or node._sequence_nr() < self.start \
                    or _tag(node) >= self.n:
                continue                  # a leaf's, made before, or done
            if _LOOP_KEY not in node.metadata:      # one hook a node
                # (not the node itself: a hook that held it would keep
                # the graph and its saved tensors alive)
                node.register_hook(functools.partial(
                    self._accumulations, node.metadata,
                    node._sequence_nr(), node.next_functions))
            node.metadata[_LOOP_KEY] = self.n
            todo.extend(nxt for nxt, _ in node.next_functions)
        return out

    def _accumulations(self, meta, seq, edges, grad_inputs, _grad_outputs):
        w = self.walk
        here = meta[_LOOP_KEY]
        sums = {}
        for g, (nxt, _) in zip(grad_inputs, edges):
            if g is None or nxt is None:
                continue
            into = max(_tag(nxt), w.loop)
            if into < here:
                sums[g._cdata] = into
                m = w.mult * (here - into)
                w.costs.elem_flops += m * g.numel()
                w.costs.bytes_accessed += m * 3 * _nbytes(g)
        w.sums = (seq, sums)


def _collapse(w: "_Walk", n: int, name: str):
    """`loops.steps` inside a collapsing walk: the first iteration only,
    its ops (and their backward) counted n times."""
    w.costs.trip_counts[name] = n
    w.loop *= n
    try:
        with _TagLoop(w, w.loop):
            yield 0
    finally:
        w.loop //= n


def bill(kind: str, nbytes: float, group: int, crosses=None) -> None:
    """Bill a collective that the run implies but does not make (the dry
    run's layout) to the innermost walk, at its current multiplier."""
    if _ACTIVE:
        w = _ACTIVE[-1]
        w.costs.add_collective(kind, nbytes, group, crosses, w.factor())


def relayout(t: torch.Tensor, nbytes: int) -> None:
    """From now on the innermost walk counts `nbytes` for the storage
    that holds t: a layout change that keeps another size of it on the
    device (the dry run's accumulator pin)."""
    if _ACTIVE:
        _ACTIVE[-1].relayout(t, nbytes)


@contextlib.contextmanager
def walking(costs: Costs, mult: float = 1.0, collapse: bool = False):
    """Count every op run inside the block into `costs`, each `mult`
    times; with `collapse`, `utils/loops.py:steps` loops run once."""
    w = _Walk(costs, mult)
    _ACTIVE.append(w)
    try:
        with w, (loops.collapsing(functools.partial(_collapse, w))
                 if collapse else contextlib.nullcontext()):
            yield w
    finally:
        _ACTIVE.pop()


def analyze(fn, *args, collapse: bool = False, **kwargs) -> Costs:
    """The costs of one call fn(*args, **kwargs)."""
    costs = Costs()
    with walking(costs, collapse=collapse):
        fn(*args, **kwargs)
    return costs


# ---------------------------------------------------------------------------
# roofline terms (NVIDIA H100 SXM constants)
# ---------------------------------------------------------------------------

PEAK_FLOPS = 989e12          # bf16 tensor cores per card (data sheet)
HBM_BW = 3.35e12             # bytes/s per card (data sheet)
NVLINK_BW = 450e9            # bytes/s each way to the host's other cards
# bytes/s each way per card between hosts: one 400 Gb/s ConnectX-7 port
# a card, as NVIDIA's DGX H100 and HGX H100 systems pair them
NET_BW = 50e9


def roofline_terms(costs: Costs) -> dict:
    """Per-device seconds for the three roofline terms.

    compute   : dot FLOPs / peak
    memory    : bytes / HBM bandwidth
    collective: wire bytes / link bandwidth, with ring factors
                (all-reduce 2(g-1)/g, gather/scatter (g-1)/g, a2a ~1);
                NVLink for a group inside one host, the network for a
                group that leaves it (an entry's fourth field; unset, a
                group of more than HOST_CARDS)
    """
    wire = 0.0
    collective_s = 0.0
    for kind, size, g, *rest in costs.collective_info:
        crosses = rest[0] if rest and rest[0] is not None \
            else (g or 0) > HOST_CARDS
        if g and g > 1:
            if kind == "all-reduce":
                w = 2.0 * size * (g - 1) / g
            elif kind in ("all-gather", "reduce-scatter"):
                w = size * (g - 1) / g
            else:
                w = size
        elif g == 1:
            continue                   # degenerate single-member group
        else:
            w = size
        wire += w
        collective_s += w / (NET_BW if crosses else NVLINK_BW)
    out = {
        "compute_s": costs.dot_flops / PEAK_FLOPS,
        "memory_s": costs.bytes_accessed / HBM_BW,
        "collective_s": collective_s,
        "dot_flops": costs.dot_flops,
        "elem_flops": costs.elem_flops,
        "bytes": costs.bytes_accessed,
        "collective_bytes": costs.total_collective_bytes(),
        "wire_bytes": wire,
        "per_kind": dict(costs.collective_bytes),
        "trip_counts": dict(costs.trip_counts),
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: out[k])
    out["bottleneck"] = dom.replace("_s", "")
    return out
