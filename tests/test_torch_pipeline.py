"""`repro_torch/train/pipeline.py` (GPipe over gloo ranks) against the
port's sequential backbone (2 and 4 ranks, float32, 1e-5) and against
JAX's `make_pipelined_forward` and `pipelined_loss` on the same weights
over a 4-device pod axis (a subprocess with
`--xla_force_host_platform_device_count=4`; 1e-4).
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
cfg = replace(configs.get_config("smollm-135m").reduced(), n_layers=4,
              remat=False)
mesh = jax.make_mesh((4, 1, 1), ("pod", "data", "model"),
                     devices=jax.devices()[:4])
params = T.init_params(cfg, jax.random.PRNGKey(0))
B, S = 4, 32
tok = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab)
lab = jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, cfg.vocab)
x = jnp.take(params["embed"], tok, axis=0).astype(cfg.compute_dtype)
with mesh:
    h = jax.jit(make_pipelined_forward(cfg, mesh, n_micro=2))(params, x)
    loss = jax.jit(pipelined_loss(cfg, mesh, 2))(
        params, {"tokens": tok, "labels": lab})
flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
        for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(out + "/jax.npz", x=np.asarray(x), h=np.asarray(h),
         loss=np.asarray(loss), tok=np.asarray(tok), lab=np.asarray(lab),
         **{"p:" + k: v for k, v in flat.items()})
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
    """JAX's pipelined forward and loss on 4 pods, and its weights."""
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
