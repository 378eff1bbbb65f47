"""`repro_torch/train/ddp_shardmap.py` against the JAX package: the int8
error-feedback all-reduce `_quantized_psum` in a world of one (bit for
bit against JAX's on a 1-device mesh) and on 2 gloo ranks (against
JAX's 2-device `shard_map`, in a subprocess with
`--xla_force_host_platform_device_count=2`), its error-feedback bound,
and the DDP step against JAX's `make_ddp_train_step` from the same
weights (`params_from_jax`), compressed and not.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_dist import SRC, run_ranks
from repro import configs as JC
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import SyntheticStream as JStream
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train import ddp_shardmap as JDDP
from repro.utils import compat
from repro_torch import configs as C
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import ddp_shardmap as DDP
from repro_torch.train.step import make_train_step

N = 1000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(ranks: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(ranks, N)).astype(np.float32)
    g[:, :3] *= 50.0                         # a wide range of magnitudes
    e = (0.01 * rng.normal(size=(ranks, N))).astype(np.float32)
    return g, e


def _jax_qpsum_1():
    mesh = jax.make_mesh((1,), ("data",), devices=jax.devices()[:1])
    return jax.jit(compat.shard_map(
        lambda g, e: JDDP._quantized_psum(g, e, "data"), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P()), check_vma=False))


def test_quantized_psum_world_of_one_bit_for_bit():
    """Five error-feedback steps, the residual fed back: mean and
    residual equal JAX's bit for bit."""
    f = _jax_qpsum_1()
    g, e = _inputs(1)
    je, te = jnp.asarray(e[0]), torch.from_numpy(e[0])
    for step in range(5):
        gi = g[0] * (1 + 0.1 * step)
        jm, je = f(jnp.asarray(gi), je)
        tm, te = DDP._quantized_psum(torch.from_numpy(gi), te)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_quantized_psum_error_feedback_bounded():
    """JAX's bound (tests/test_system.py): the residual stays within
    2.1 quantization steps after step 10 of 50."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    e = torch.zeros(256)
    errs = []
    for _ in range(50):
        _mean, e = DDP._quantized_psum(g, e)
        errs.append(float(e.abs().max()))
    scale = float(g.abs().max()) / 127.0
    assert max(errs[10:]) <= 2.1 * scale


QPSUM = r"""
import sys
import numpy as np, torch
from repro_torch.train import comm
from repro_torch.train.ddp_shardmap import _quantized_psum
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
comm.init_group(rank, world, port, "cpu")
z = np.load(out + "/inputs.npz")
stats = comm.Stats()
mean, err = _quantized_psum(torch.from_numpy(z["g"][rank]),
                            torch.from_numpy(z["e"][rank]), None, stats)
np.savez(out + f"/rank{rank}.npz", mean=mean.numpy(), err=err.numpy(),
         calls=stats.calls, bytes=stats.bytes)
torch.distributed.destroy_process_group()
"""

JAX_QPSUM = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.train.ddp_shardmap import _quantized_psum
from repro.utils import compat
z = np.load(sys.argv[1] + "/inputs.npz")
mesh = jax.make_mesh((2,), ("data",), devices=jax.devices()[:2])
f = jax.jit(compat.shard_map(lambda g, e: _quantized_psum(g, e, "data"),
            mesh=mesh, in_specs=(P("data"), P("data")),
            out_specs=(P("data"), P("data")), check_vma=False))
m, e = f(jnp.asarray(z["g"]), jnp.asarray(z["e"]))
np.savez(sys.argv[1] + "/jax.npz", mean=np.asarray(m), err=np.asarray(e))
print("JAX_QPSUM_OK")
"""


def test_quantized_psum_two_ranks_match_jax_shard_map(tmp_path):
    g, e = _inputs(2, seed=1)
    np.savez(tmp_path / "inputs.npz", g=g, e=e)
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", JAX_QPSUM, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert "JAX_QPSUM_OK" in r.stdout, r.stderr[-3000:]
    want = np.load(tmp_path / "jax.npz")
    ranks = run_ranks(QPSUM, 2, tmp_path)
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got["mean"], want["mean"][rank])
        np.testing.assert_array_equal(got["err"], want["err"][rank])
        # one MAX of a scalar, one int32 SUM of the tensor (JAX's psum)
        assert int(got["calls"]) == 2 and int(got["bytes"]) == 4 + 4 * N
    np.testing.assert_array_equal(ranks[0]["mean"], ranks[1]["mean"])


def _cfg():
    return C.get_config("smollm-135m").reduced()


def test_ddp_step_tracks_jax():
    """Three steps of the DDP step on JAX's weights in a world of one
    against JAX's on a 1-device mesh, compressed and not: losses within
    1e-4 (float32)."""
    jcfg, cfg = JC.get_config("smollm-135m").reduced(), _cfg()
    mesh = jax.make_mesh((1,), ("data",), devices=jax.devices()[:1])
    jo, po = JA.AdamWConfig(lr=3e-3, warmup_steps=2), \
        adamw.AdamWConfig(lr=3e-3, warmup_steps=2)
    jstream = JStream(JDataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4, seed=9))
    pstream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                         global_batch=4, seed=9))
    params0 = JT.init_params(jcfg, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params0)
    for compress in (False, True):
        jstep = JDDP.make_ddp_train_step(jcfg, jo, mesh, compress=compress)
        params, opt = params0, JA.init_state(params0, jo)
        err = JDDP.init_error_buffers(params0)
        model = T.params_from_jax(cfg, host, "cpu")
        popt = adamw.init_state(dict(model.named_parameters()), po)
        perr = DDP.init_error_buffers(model)
        step = DDP.make_ddp_train_step(cfg, po, compress=compress)
        for i in range(3):
            jb = {k: jnp.asarray(v) for k, v in jstream.batch(i).items()}
            params, opt, err, jl = jstep(params, opt, err, jb)
            tb = {k: torch.from_numpy(v).long()
                  for k, v in pstream.batch(i).items()}
            model, popt, perr, tl = step(model, popt, perr, tb)
            assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl)), \
                (compress, i, float(tl), float(jl))


DDP_RUN = r"""
import sys
import numpy as np, torch
from repro_torch import configs as C
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import comm
from repro_torch.train import ddp_shardmap as DDP
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
steps = int(sys.argv[5])
comm.init_group(rank, world, port, "cpu")
cfg = C.get_config("smollm-135m").reduced()
ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2)
stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=4, seed=9))
res = {}
# the gradients each step hands the optimizer: the exchange's result
seen = []
apply_grads = DDP.apply_grads
def spy(model, opt, grads, opt_cfg):
    seen.append({k: g.clone() for k, g in grads.items()})
    return apply_grads(model, opt, grads, opt_cfg)
DDP.apply_grads = spy
for compress in (False, True):
    model = T.init_params(cfg, 0, "cpu")
    opt = adamw.init_state(dict(model.named_parameters()), ocfg)
    err = DDP.init_error_buffers(model)
    step = DDP.make_ddp_train_step(cfg, ocfg, compress=compress)
    losses = []
    seen.clear()
    for i in range(steps):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in stream.batch(i).items()}
        model, opt, err, loss = step(model, opt, err, batch)
        losses.append(float(loss))
    res[f"losses_{int(compress)}"] = np.array(losses)
    res[f"calls_{int(compress)}"] = step.stats.calls
    res[f"digest_{int(compress)}"] = np.frombuffer(
        b"".join(p.detach().numpy().tobytes()
                 for p in model.parameters()), np.uint8)[:4096]
    for k, g in seen[0].items():
        res[f"grad_{int(compress)}/{k}"] = g.numpy()
np.savez(out + f"/rank{rank}.npz", **res)
torch.distributed.destroy_process_group()
"""


def _single_process(cfg, ocfg, stream, steps: int):
    """make_train_step on the global batch in one process: its losses,
    and the first step's float32 gradients on the whole batch and on
    each of two ranks' halves."""
    from repro_torch.train.step import make_grad_fn
    model = T.init_params(cfg, 0, "cpu")
    batch0 = {k: torch.from_numpy(v).long()
              for k, v in stream.batch(0).items()}
    grad_fn = make_grad_fn(cfg)
    grads = {k: g.float() for k, g in grad_fn(model, batch0)[2].items()}
    halves = [{k: g.float() for k, g in grad_fn(
        model, {k: x[r * 2:(r + 1) * 2] for k, x in batch0.items()})[2]
        .items()} for r in range(2)]
    opt = adamw.init_state(dict(model.named_parameters()), ocfg)
    step = make_train_step(cfg, ocfg)
    losses = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in stream.batch(i).items()}
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
    return np.array(losses), grads, halves


def test_compressed_ddp_tracks_uncompressed_on_two_ranks(tmp_path):
    """JAX's test_compressed_ddp_tracks_uncompressed on 2 gloo ranks: 12
    steps each way, both curves fall, the last losses within 0.25; the
    ranks agree on every loss and parameter.  The exchange is held
    against one process's `make_train_step` on the global batch: every
    uncompressed loss within 1e-5 relative, the first step's averaged
    gradient within 1e-5 of each leaf's largest entry (a sum instead of
    a mean would be 2x), and the compressed one within half a
    quantization step of the two halves' mean."""
    ranks = run_ranks(DDP_RUN, 2, tmp_path, 12)
    a, b = ranks
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    plain, comp = a["losses_0"], a["losses_1"]
    assert plain[-1] < plain[0] and comp[-1] < comp[0]
    assert abs(comp[-1] - plain[-1]) < 0.25
    # collectives per step: the loss, then a float32 sum per leaf, or a
    # MAX and an int32 SUM per leaf
    n = len(list(T.init_params(_cfg(), 0, "cpu").parameters()))
    assert int(a["calls_0"]) == 12 * (1 + n)
    assert int(a["calls_1"]) == 12 * (1 + 2 * n)
    cfg = _cfg()
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                        global_batch=4, seed=9))
    losses, grads, halves = _single_process(cfg, ocfg, stream, 12)
    np.testing.assert_allclose(plain, losses, rtol=1e-5, atol=0)
    for k, g in grads.items():
        g = g.numpy()
        top = float(np.abs(g).max())
        np.testing.assert_allclose(a[f"grad_0/{k}"], g, rtol=0,
                                   atol=1e-5 * top, err_msg=k)
        h = [x[k].numpy() for x in halves]
        step = max(float(np.abs(x).max()) for x in h) / 127.0
        d = np.abs(a[f"grad_1/{k}"] - (h[0] + h[1]) / 2).max()
        assert d <= 0.5 * step * (1 + 1e-5) + 1e-6 * top, (k, d, step)
