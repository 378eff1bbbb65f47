"""`repro_torch/train/pipeline.py` (GPipe over gloo ranks) against the
port's sequential backbone (2 and 4 ranks, float32, 1e-5) and against
JAX's `make_pipelined_forward` and `pipelined_loss` on the same weights
over a 4-device pod axis (a subprocess with
`--xla_force_host_platform_device_count=4`; 1e-4).

The pipelined loss's gradient (`train/comm.py`'s `ring_shift_ad`,
`share_ad` and `replicated_ad`) against `jax.grad` of JAX's
`pipelined_loss` on 2 and 4 pods (the same subprocess), and for the
dense smollm-135m also against the port's sequential gradient
(`train/step.py:make_grad_fn`), at the tolerances that
tests/test_torch_train_model.py holds the sequential gradient to
against `jax.grad`: loss rtol 1e-5, every leaf rtol 1e-3 with atol 1e-5
x its max |g|.  Every multi-rank case has 120 s: a backward whose sends
and receives do not pair up hangs, and fails there.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist import SRC, run_ranks
from repro_torch import configs as C
from repro_torch.models import transformer as T
from repro_torch.train import pipeline as PL

B, S, N_MICRO = 4, 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX_PIPE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from dataclasses import replace
import numpy as np, jax, jax.numpy as jnp
from repro import configs
from repro.models import transformer as T
from repro.train.pipeline import make_pipelined_forward, pipelined_loss
out = sys.argv[1]


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


B, S = 4, 32
# smollm-135m: the forward and loss on 4 pods, jax.grad of the loss on 4
# and 2 pods; phi3.5-moe: jax.grad of the loss on 2 pods
for arch, name, pods in (("smollm-135m", "jax", (4, 2)),
                         ("phi3.5-moe-42b-a6.6b", "moe", (2,))):
    cfg = replace(configs.get_config(arch).reduced(), n_layers=4,
                  remat=False)
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    tok = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab)
    lab = jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, cfg.vocab)
    batch = {"tokens": tok, "labels": lab}
    x = jnp.take(params["embed"], tok, axis=0).astype(cfg.compute_dtype)
    res = {"x": np.asarray(x), "tok": np.asarray(tok), "lab": np.asarray(lab)}
    for n in pods:
        mesh = jax.make_mesh((n, 1, 1), ("pod", "data", "model"),
                             devices=jax.devices()[:n])
        with mesh:
            if n == 4:
                res["h"] = np.asarray(jax.jit(make_pipelined_forward(
                    cfg, mesh, n_micro=2))(params, x))
                res["loss"] = np.asarray(jax.jit(pipelined_loss(
                    cfg, mesh, 2))(params, batch))
            loss, grads = jax.jit(jax.value_and_grad(
                pipelined_loss(cfg, mesh, 2)))(params, batch)
        res[f"loss{n}"] = np.asarray(loss)
        res.update({f"g{n}:" + k: v for k, v in flat(grads).items()})
    res.update({"p:" + k: v for k, v in flat(params).items()})
    np.savez(out + f"/{name}.npz", **res)
print("JAX_PIPE_OK")
"""

PIPE = r"""
import sys
from dataclasses import replace
import numpy as np, torch
from repro_torch import configs as C
from repro_torch.models import transformer as T
from repro_torch.train import comm, pipeline as PL
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
comm.init_group(rank, world, port, "cpu")
z = np.load(out + "/jax.npz")
tree = {}
for k in z.files:
    if k.startswith("p:"):
        node = tree
        *path, leaf = k[2:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = z[k]
cfg = replace(C.get_config("smollm-135m").reduced(), n_layers=4, remat=False)
model = T.params_from_jax(cfg, tree, "cpu")
stats = comm.Stats()
h = PL.make_pipelined_forward(cfg, None, 2)(model, torch.from_numpy(z["x"]))
loss = PL.pipelined_loss(cfg, None, 2)(model, {
    "tokens": torch.from_numpy(z["tok"]).long(),
    "labels": torch.from_numpy(z["lab"]).long()})
np.savez(out + f"/rank{rank}.npz", h=h.numpy(), loss=loss.numpy())
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's pipelined forward and loss on 4 pods, the gradients of its
    pipelined loss (smollm-135m on 4 and 2 pods in jax.npz, phi3.5-moe
    on 2 in moe.npz), and the weights."""
    out = tmp_path_factory.mktemp("pipe")
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", JAX_PIPE, str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert "JAX_PIPE_OK" in r.stdout, r.stderr[-3000:]
    return out


def _sequential(out):
    """The port's backbone on JAX's weights, before the final norm."""
    from dataclasses import replace
    z = np.load(out / "jax.npz")
    tree = {}
    for k in z.files:
        if k.startswith("p:"):
            node = tree
            *path, leaf = k[2:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[k]
    cfg = replace(C.get_config("smollm-135m").reduced(), n_layers=4,
                  remat=False)
    model = T.params_from_jax(cfg, tree, "cpu")
    x = torch.from_numpy(z["x"])
    pos = torch.arange(S)[None].expand(B, S)
    with torch.no_grad():
        h = PL._stage_apply(model.blocks, x, cfg, pos)
    return cfg, model, z, h


@pytest.mark.parametrize("ranks", [2, 4])
def test_pipelined_forward_matches_sequential_and_jax(jax_run, ranks):
    _cfg, _model, z, seq = _sequential(jax_run)
    got = run_ranks(PIPE, ranks, jax_run)
    for r in got:
        np.testing.assert_allclose(r["h"], seq.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["h"], z["h"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["loss"], z["loss"], rtol=1e-4)
    np.testing.assert_array_equal(got[0]["h"], got[-1]["h"])


def test_pipeline_requirements_raise():
    """JAX's asserts: the batch splits into n_micro microbatches (and the
    repeat units over the stages); a world of one runs every layer."""
    from dataclasses import replace
    cfg = replace(C.get_config("smollm-135m").reduced(), n_layers=4,
                  remat=False)
    model = T.init_params(cfg, 0, "cpu")
    x = torch.randn(3, 8, cfg.d_model)
    with pytest.raises(ValueError, match="microbatches"):
        PL.make_pipelined_forward(cfg, None, 2)(model, x)
    h = PL.make_pipelined_forward(cfg, None, 3)(model, x)
    pos = torch.arange(8)[None].expand(1, 8)
    with torch.no_grad():
        want = torch.cat([PL._stage_apply(model.blocks, x[i:i + 1], cfg, pos)
                          for i in range(3)])
    torch.testing.assert_close(h, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the pipelined loss's gradient
# ---------------------------------------------------------------------------

LOSS_RTOL = 1e-5                      # tests/test_torch_train_model.py's
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5     # atol x the leaf's max |g|
RANKS_TIMEOUT = 120

PIPE_GRAD = r"""
import sys
from dataclasses import replace
import numpy as np, torch
from repro_torch import configs as C
from repro_torch.models import transformer as T
from repro_torch.train import comm, pipeline as PL
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
arch, name = sys.argv[5], sys.argv[6]
comm.init_group(rank, world, port, "cpu")
z = np.load(out + f"/{name}.npz")
tree = {}
for k in z.files:
    if k.startswith("p:"):
        node = tree
        *path, leaf = k[2:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = z[k]
cfg = replace(C.get_config(arch).reduced(), n_layers=4, remat=False)
model = T.params_from_jax(cfg, tree, "cpu").requires_grad_(True)
batch = {"tokens": torch.from_numpy(z["tok"]).long(),
         "labels": torch.from_numpy(z["lab"]).long()}
kinds = ("ring", "share", "input")


def counts(stats):
    return {k: np.array([stats[k].calls, stats[k].bytes]) for k in kinds}


with torch.no_grad():
    plain = {k: comm.Stats() for k in kinds}
    loss_ng = PL.pipelined_loss(cfg, None, 2, plain)(model, batch)
stats = {k: comm.Stats() for k in kinds}
loss = PL.pipelined_loss(cfg, None, 2, stats)(model, batch)
fwd = counts(stats)
names, params = zip(*model.named_parameters())
grads = torch.autograd.grad(loss, params, materialize_grads=True)
total = counts(stats)
np.savez(out + f"/rank{rank}.npz", loss=loss.detach().numpy(),
         loss_ng=loss_ng.numpy(),
         **{"g:" + n: g.numpy() for n, g in zip(names, grads)},
         **{"ng:" + k: v for k, v in counts(plain).items()},
         **{"fwd:" + k: v for k, v in fwd.items()},
         **{"bwd:" + k: total[k] - fwd[k] for k in kinds})
torch.distributed.destroy_process_group()
"""


def _unflatten(z, prefix: str) -> dict:
    tree = {}
    for k in z.files:
        if k.startswith(prefix):
            node = tree
            *path, leaf = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[k]
    return tree


def _cfg(arch):
    from dataclasses import replace
    return replace(C.get_config(arch).reduced(), n_layers=4, remat=False)


def _stage_of(name: str, cfg, world: int):
    """The stage that holds a layer's parameter; None for the embedding,
    the final norm and the head (every rank's)."""
    if not name.startswith("blocks."):
        return None
    return int(name.split(".")[1]) // (cfg.n_layers // world)


_RUNS: dict = {}


def _grad_run(jax_run, arch: str, name: str, world: int):
    """(cfg, JAX's npz, the ranks' npz, JAX's pipelined gradient by the
    port's parameter names); the ranks run once per case."""
    key = (arch, world)
    if key not in _RUNS:
        _RUNS[key] = run_ranks(PIPE_GRAD, world, jax_run, arch, name,
                               timeout=RANKS_TIMEOUT)
    z = np.load(jax_run / f"{name}.npz")
    cfg = _cfg(arch)
    want = T.state_from_jax(cfg, _unflatten(z, f"g{world}:"))
    return cfg, z, _RUNS[key], want


def _owned(cfg, got, world: int) -> dict:
    """Each parameter's gradient from the rank that holds it (rank 0 for
    the replicated leaves)."""
    return {k[2:]: got[_stage_of(k[2:], cfg, world) or 0][k]
            for k in got[0] if k.startswith("g:")}


def _held(got: dict, want: dict, what: str) -> float:
    """Every leaf within GRAD_RTOL / GRAD_ATOL x its max |g|; returns the
    worst max |err| / max |g|."""
    assert set(got) == set(want)
    worst = 0.0
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale,
                                   err_msg=f"{what}: {k}")
        if scale:
            worst = max(worst, float(np.abs(got[k] - w).max()) / scale)
    return worst


@pytest.mark.parametrize("ranks", [2, 4])
def test_pipelined_gradient_matches_jax_and_sequential(jax_run, ranks):
    """smollm-135m reduced to 4 layers, 2 microbatches (at 4 ranks fewer
    than the stages: stages idle, and a missing backward node would
    hang): the port's loss and gradient equal jax.grad of JAX's
    pipelined loss on as many pods, and the port's sequential
    `make_grad_fn` on the same weights and batch (a dense model: the
    pipeline changes no value)."""
    from repro_torch.train.step import make_grad_fn
    cfg, z, got, want = _grad_run(jax_run, "smollm-135m", "jax", ranks)
    model = T.params_from_jax(cfg, _unflatten(z, "p:"), "cpu")
    batch = {"tokens": torch.from_numpy(z["tok"]).long(),
             "labels": torch.from_numpy(z["lab"]).long()}
    seq_loss, _m, seq = make_grad_fn(cfg)(model, batch)
    for r in got:
        np.testing.assert_allclose(r["loss"], z[f"loss{ranks}"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["loss"], float(seq_loss),
                                   rtol=LOSS_RTOL)
        assert r["loss"] == r["loss_ng"]         # no_grad: the same value
    mine = _owned(cfg, got, ranks)
    _held(mine, want, f"against JAX's pipelined gradient, {ranks} pods")
    _held(mine, {k: g.numpy() for k, g in seq.items()},
          "against the sequential gradient")


@pytest.mark.parametrize("ranks", [2, 4])
def test_pipelined_gradient_sits_where_jax_puts_it(jax_run, ranks):
    """After the backward each layer's gradient is on the rank of its
    stage and zero on the others (JAX: the pod that holds that slice of
    `blocks`), and the embedding's and final norm's are equal, bit for
    bit, on every rank (JAX: replicated)."""
    cfg, _z, got, _want = _grad_run(jax_run, "smollm-135m", "jax", ranks)
    for k in got[0]:
        if not k.startswith("g:"):
            continue
        stage = _stage_of(k[2:], cfg, ranks)
        if stage is None:
            for r in got[1:]:
                np.testing.assert_array_equal(r[k], got[0][k], err_msg=k)
            continue
        assert got[stage][k].any(), k
        for r, g in enumerate(got):
            if r != stage:
                assert not g[k].any(), (k, r)


@pytest.mark.parametrize("ranks", [2, 4])
def test_pipelined_backward_counts_its_collectives(jax_run, ranks):
    """`comm.Stats` of the pipeline: the forward shifts once a tick
    (n_micro + P - 1) and shares once; the backward shifts once a tick
    but the last (whose output feeds nothing), transposes the share once
    and sums the replicated input's cotangent once; under no_grad the
    forward's collectives are the same and nothing else runs."""
    cfg, z, got, _want = _grad_run(jax_run, "smollm-135m", "jax", ranks)
    ticks = N_MICRO + ranks - 1
    buf = (B // N_MICRO) * S * cfg.d_model * 4
    whole = B * S * cfg.d_model * 4
    for r in got:
        for k, want in (("ring", (ticks, ticks * buf)), ("share", (1, whole)),
                        ("input", (0, 0))):
            np.testing.assert_array_equal(r["fwd:" + k], want, err_msg=k)
            np.testing.assert_array_equal(r["ng:" + k], want, err_msg=k)
        for k, want in (("ring", (ticks - 1, (ticks - 1) * buf)),
                        ("share", (1, whole)), ("input", (1, whole))):
            np.testing.assert_array_equal(r["bwd:" + k], want, err_msg=k)


def test_pipelined_moe_gradient_matches_jax(jax_run):
    """phi3.5-moe reduced to 4 layers over 2 ranks: the port's loss and
    gradient equal jax.grad of JAX's pipelined loss on 2 pods.  Not the
    sequential gradient: MoE capacity ceil(k T / E cf) is computed per
    call, and in the pipeline T is a microbatch's tokens, not the
    batch's, so the dispatch differs; the pipelined CE here is not the
    sequential one."""
    from repro_torch.train.step import make_grad_fn
    cfg, z, got, want = _grad_run(jax_run, "phi3.5-moe-42b-a6.6b", "moe", 2)
    for r in got:
        np.testing.assert_allclose(r["loss"], z["loss2"], rtol=LOSS_RTOL)
    _held(_owned(cfg, got, 2), want, "against JAX's pipelined gradient")
    model = T.params_from_jax(cfg, _unflatten(z, "p:"), "cpu")
    _loss, metrics, _g = make_grad_fn(cfg)(model, {
        "tokens": torch.from_numpy(z["tok"]).long(),
        "labels": torch.from_numpy(z["lab"]).long()})
    assert abs(float(metrics["ce"]) - float(got[0]["loss"])) \
        > 10 * LOSS_RTOL * float(got[0]["loss"])


TRANSPOSES = r"""
import sys
import numpy as np, torch
from repro_torch.train import comm
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
comm.init_group(rank, world, port, "cpu")
stats = {k: comm.Stats() for k in ("ring", "share", "input")}


def ct(r):
    return torch.arange(3.0) + 10.0 * (r + 1)   # rank r's cotangent


t = torch.full((3,), float(rank), requires_grad=True)
y = comm.ring_shift_ad(t, None, stats["ring"])
(y * ct(rank)).sum().backward()
u = torch.full((3,), rank + 1.0, requires_grad=True)
v = comm.share_ad(u * 1.0, None, stats["share"])
(v * ct(rank)).sum().backward()
x = torch.full((3,), 7.0, requires_grad=True)
w = comm.replicated_ad(x, None, stats["input"])
(w * ct(rank)).sum().backward()
np.savez(out + f"/rank{rank}.npz", y=y.detach().numpy(),
         t_grad=t.grad.numpy(), v=v.detach().numpy(), u_grad=u.grad.numpy(),
         w=w.detach().numpy(), x_grad=x.grad.numpy(),
         **{k: np.array([s.calls, s.bytes]) for k, s in stats.items()})
torch.distributed.destroy_process_group()
"""


def test_collective_transposes(tmp_path):
    """Over 4 gloo ranks, with a different cotangent ct_r on each rank:
    the ring shift brings rank r-1's tensor and its backward gives rank r
    the cotangent of rank r+1 (the inverse permutation); the share sums
    and gives each rank sum_r ct_r / 4; the replicated input is the
    identity and gets sum_r ct_r; each collective, forward and backward,
    is counted once in its `Stats`."""
    got = run_ranks(TRANSPOSES, 4, tmp_path, timeout=RANKS_TIMEOUT)

    def ct(r):
        return np.arange(3.0) + 10.0 * (r + 1)

    total = sum(ct(r) for r in range(4))
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["y"], np.full(3, (r - 1) % 4))
        np.testing.assert_array_equal(g["t_grad"], ct((r + 1) % 4))
        np.testing.assert_array_equal(g["v"], np.full(3, 10.0))
        np.testing.assert_array_equal(g["u_grad"], total / 4)
        np.testing.assert_array_equal(g["w"], np.full(3, 7.0))
        np.testing.assert_array_equal(g["x_grad"], total)
        np.testing.assert_array_equal(g["ring"], (2, 24))
        np.testing.assert_array_equal(g["share"], (2, 24))
        np.testing.assert_array_equal(g["input"], (1, 12))
