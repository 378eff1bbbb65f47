"""The LM's layout against the JAX package: `repro_torch/launch/specs.py`,
`optim/adamw.py:zero1_spec`, `launch/dryrun.py:microbatch_policy` and
the dry run's per-device argument bytes, for every leaf of all ten
archs at full size (JAX's parameters from `jax.eval_shape`, the port's
on fake tensors) on both production meshes (JAX's `AbstractMesh`, the
port's `launch/mesh.py:abstract_mesh`); `models/sharding.py`; the
elastic restore of `checkpoint/ckpt.py`.

The port's specs are in its own layout (nn.Linear weights (out, in),
no repeat axis); each is mapped back to JAX's layout here.
"""

import importlib
import math
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as JC
from repro.launch import specs as JSP
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch import configs as C
from repro_torch.checkpoint import ckpt as CK
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MS
from repro_torch.launch import specs as SP
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

ARCHS = C.list_archs()
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(tree) -> dict:
    """{"/"-joined key path: leaf} of a JAX pytree."""
    return {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in kp): x
            for kp, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pad(spec, n) -> tuple:
    t = tuple(spec)
    return t + (None,) * (n - len(t))


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), MS.abstract_mesh(shape, axes)


def _to_jax(cfg, name, spec, shape, reps):
    """A port leaf's spec and shape in JAX's layout (repeat axis first
    for a block leaf)."""
    path, stacked, transposed = SP.jax_path(cfg, name)
    if transposed:
        spec, shape = tuple(reversed(spec)), tuple(reversed(shape))
    if stacked:
        spec, shape = (None,) + tuple(spec), (reps[path.split("/")[1]],) \
            + tuple(shape)
    return path, tuple(spec), tuple(shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_zero1_and_argument_bytes_match_jax(arch):
    """Every parameter's spec and ZeRO-1 optimizer spec, and the train
    cell's argument bytes, on both meshes."""
    jcfg, cfg = JC.get_config(arch), C.get_config(arch)
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    jshape = _paths(jp)
    ps = SP.param_shapes(cfg)
    reps = {"blocks": T.n_repeats(cfg), "enc_blocks": cfg.n_enc_layers}
    assert len(ps) == sum(
        x.shape[0] if p.split("/")[1] in reps else 1
        for p, x in jshape.items())
    for mname in MESHES:
        jm, pm = _meshes(mname)
        jsh = JSP.param_shardings(jcfg, jm, jp)
        jspec = _paths(jsh)
        psp = SP.param_shardings(cfg, pm, ps)
        for name, sd in ps.items():
            path, spec, shape = _to_jax(cfg, name, psp[name], sd.shape, reps)
            assert shape == jshape[path].shape, (name, path)
            assert str(sd.dtype).split(".")[1] == str(jshape[path].dtype)
            assert spec == _pad(jspec[path].spec, len(shape)), (mname, name)
        # ZeRO-1: equal, but where JAX shards the repeat axis (which the
        # port has not): there the port shards the layer's own dims
        sdt = "bfloat16" if jcfg.n_params() > 5e10 else "float32"
        jopt = jax.eval_shape(
            lambda p: JA.init_state(p, JA.AdamWConfig(state_dtype=sdt)), jp)
        jo = _paths(JSP.opt_state_shardings(jcfg, jm, jopt, jsh)["m"])
        po = SP.opt_state_shardings(cfg, pm, {"m": ps, "v": ps}, psp)
        stack_split = 0
        for name, sd in ps.items():
            path, spec, shape = _to_jax(cfg, name, po["m"][name], sd.shape,
                                        reps)
            want = _pad(jo[path].spec, len(shape))
            if SP.jax_path(cfg, name)[1] and want[0] is not None:
                stack_split += 1
                body = _to_jax(cfg, name, psp[name], sd.shape, reps)[1][1:]
                want = (None,) + adamw.zero1_spec(body, shape[1:], pm)
            assert spec == want, (mname, name)
        # rwkv6-7b alone stacks 32 layers on a data axis of 16
        assert (stack_split > 0) == (arch == "rwkv6-7b")
        # the argument bytes of the train cell: JAX's shard shapes summed
        shape = JC.SHAPES["train_4k"]
        avals, in_sh = JSP.input_specs(jcfg, shape, jm)

        def local(tree, shard):
            return sum(math.prod(s.shard_shape(x.shape))
                       * np.dtype(x.dtype).itemsize for x, s in zip(
                           jax.tree.leaves(tree), jax.tree.leaves(
                               shard, is_leaf=lambda y: isinstance(
                                   y, NamedSharding))))

        want = local(jp, jsh) + local(avals, in_sh) + local(
            jopt, JSP.opt_state_shardings(jcfg, jm, jopt, jsh))
        lay = D.cell_layout(cfg, C.SHAPES["train_4k"], pm, pshapes=ps)
        assert lay["argument_bytes"] == want, (mname, arch)
        assert lay["opt_state_dtype"] == sdt


def _jax_name(dt) -> str:
    return str(dt).split(".")[-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_and_caches_match_jax(arch):
    """input_specs for every shape cell on both meshes: shapes, dtypes and
    specs; a decode cell's cache entry by entry (JAX's stacked on the
    repeat axis, the batch at its dim 1)."""
    jcfg, cfg = JC.get_config(arch), C.get_config(arch)
    plen = len(T.block_pattern(cfg))
    for mname in MESHES:
        jm, pm = _meshes(mname)
        for sname, shape in C.SHAPES.items():
            javals, jsh = JSP.input_specs(jcfg, JC.SHAPES[sname], jm)
            avals, spec = SP.input_specs(cfg, shape, pm)
            if shape.kind != "decode":
                assert set(avals) == set(javals)
                for k, a in avals.items():
                    assert a.shape == javals[k].shape
                    assert _jax_name(a.dtype) == str(javals[k].dtype)
                    assert spec[k] == _pad(jsh[k].spec, len(a.shape)), k
                continue
            for k, a in avals["batch"].items():
                assert a.shape == javals["batch"][k].shape
                assert _jax_name(a.dtype) == str(javals["batch"][k].dtype)
                assert spec["batch"][k] == _pad(jsh["batch"][k].spec,
                                                len(a.shape))
            assert spec["pos"] == tuple(jsh["pos"].spec)
            assert avals["pos"].shape == ()
            jc = javals["cache"]["blocks"]
            jcs = jsh["cache"]["blocks"]
            assert len(avals["cache"]) == cfg.n_layers
            for i, layer in enumerate(avals["cache"]):
                slot = f"slot{i % plen}"
                assert set(layer) == set(jc[slot])
                for k, a in layer.items():
                    j = jc[slot][k]
                    assert (T.n_repeats(cfg),) + a.shape == j.shape
                    assert _jax_name(a.dtype) == str(j.dtype)
                    got = (None,) + spec["cache"][i][k]
                    assert got == _pad(jcs[slot][k].spec, len(j.shape)), \
                        (mname, sname, i, k)


def _jax_dryrun():
    """repro.launch.dryrun, imported with the XLA_FLAGS it sets undone:
    this process's JAX keeps its own device count."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def test_microbatch_policy_matches_jax_on_all_cells():
    jd = _jax_dryrun()
    n = 0
    for arch in ARCHS:
        for sname in C.SHAPES:
            for mname in MESHES:
                jm, pm = _meshes(mname)
                got = D.microbatch_policy(C.get_config(arch),
                                          C.SHAPES[sname], pm)
                assert got == jd.microbatch_policy(
                    JC.get_config(arch), JC.SHAPES[sname], jm)
                n += 1
    assert n == 80


def test_spec_for_and_constrain():
    """spec_for drops a non-dividing axis and expands "data" on a pod
    mesh, as JAX's; constrain is the identity, and reports its spec and
    role to an observer only under a mesh; an unknown role raises
    there."""
    from repro.models import sharding as JS
    x = torch.zeros(32, 8, 64)
    seen = []
    assert S.constrain(x, "data", None, "model", role="mlp_in") is x
    with S.observe(lambda t, spec, role: seen.append((spec, role))):
        assert S.constrain(x, "data", None, "model", role="mlp_in") is x
        assert not seen                        # no mesh, no report
        for mname in MESHES:
            jm, pm = _meshes(mname)
            with S.use_mesh(pm):
                JS.set_mesh(jm)
                try:
                    for axes in (("data", None, "model"),
                                 ("data", "model", None), ("model",),
                                 (("pod", "data"), None, None)):
                        assert S.spec_for(x.shape, *axes) == \
                            tuple(JS.spec_for(x.shape, *axes))
                finally:
                    JS.set_mesh(None)
                assert S.constrain(x, "data", None, "model",
                                   role="mlp_in") is x
                with pytest.raises(ValueError, match="unknown role"):
                    S.constrain(x, "data", role="mlp")
    assert seen[-1] == ((("pod", "data"), None, "model"), "mlp_in")
    assert S.get_mesh() is None


def _expected_roles(cfg) -> dict:
    """The `constrain` reports of one prefill, by role, from the layer
    slots: the embedding; q, k, v per attention (the encoder's too); the
    MLP's input, gate (SwiGLU) and output; the MoE's dispatch and output;
    RWKV's time-mix output and channel-mix hidden; Mamba's inner stream;
    the seq-parallel residual before the layers and after each unit."""
    want = {"embed": 1}

    def add(role, n=1):
        want[role] = want.get(role, 0) + n

    def mlp():
        add("mlp_in")
        add("mlp_out")
        if cfg.act == "swiglu":
            add("mlp_gate")

    slots = T.layer_slots(cfg) + [("attn", "mlp")] * cfg.n_enc_layers
    for mixer, ffn in slots:
        if mixer == "attn":
            for r in "qkv":
                add(r)
        elif mixer == "mamba":
            add("mamba_inner")
        else:
            add("timemix_out")
        if ffn == "rwkv_cm":
            add("channelmix_hidden")
        if ffn.startswith("moe"):
            add("moe_dispatch")
            add("moe_out")
        if ffn in ("mlp", "moe+mlp"):
            mlp()
    if cfg.seq_parallel:
        add("residual", 1 + T.n_repeats(cfg))
    return want


@pytest.mark.parametrize("arch", C.list_archs())
def test_constrain_reports_by_role(arch):
    """Every `constrain` point of a reduced model's prefill reports once
    under a mesh, with its role: the dry run bills by role, so a point
    added, dropped or left without a role shows here."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = C.get_config(arch).reduced()
    seen = {}

    def count(x, spec, role):
        assert role in S.ROLES and len(spec) == x.ndim
        seen[role] = seen.get(role, 0) + 1

    with FakeTensorMode():
        model = T.init_params(cfg, 0, "cpu")
        if cfg.embed_stub and cfg.family != "encdec":
            batch = {"embeds": torch.empty((2, 64, cfg.d_model),
                                           dtype=cfg.compute_dtype)}
        else:
            batch = {"tokens": torch.zeros((2, 64), dtype=torch.long)}
        if cfg.family == "encdec":
            batch["enc_embeds"] = torch.empty(
                (2, cfg.enc_seq, cfg.d_model), dtype=cfg.compute_dtype)
        with S.use_mesh(MS.abstract_mesh((2, 2), ("data", "model"))), \
                S.observe(count), torch.no_grad():
            T.forward_prefill(model, batch)
    assert seen == _expected_roles(cfg)


def test_mesh_groups_and_hosts():
    """Row-major groups: "model" is 16 consecutive shards (two hosts of
    8), "data" strides 16; a 2-shard group sits in one host."""
    mesh = MS.abstract_production_mesh(multi_pod=True)
    assert mesh.sizes == {"pod": 2, "data": 16, "model": 16}
    assert MS.group_members(mesh, "model") == list(range(16))
    assert MS.group_members(mesh, "data") == list(range(0, 256, 16))
    assert len(MS.group_members(mesh, ("pod", "data"))) == 32
    assert MS.crosses_hosts(mesh, "model")
    assert not MS.crosses_hosts(MS.abstract_mesh((4, 2), ("data", "model")),
                                "model")
    assert S.shard_index(("data", None), MS.abstract_mesh((2, 2), (
        "data", "model")), 3) == ((1, 2), (0, 1))


def test_elastic_restore_onto_zero1_layout(tmp_path):
    """Saved from one device, restored onto a 2-rank ZeRO-1 layout: every
    leaf comes back as the rank's slice, and the ranks' slices make the
    leaf."""
    cfg = C.get_config("smollm-135m").reduced()
    model = T.init_params(cfg, 0, "cpu")
    params = dict(model.named_parameters())
    ocfg = adamw.AdamWConfig()
    opt = adamw.init_state(params, ocfg)
    opt = {"m": {k: torch.randn(p.shape) for k, p in params.items()},
           "v": {k: torch.rand(p.shape) for k, p in params.items()},
           "step": opt["step"]}
    tree = {"params": params, "opt": opt}
    CK.save(str(tmp_path), 3, tree)
    mesh = MS.make_host_mesh(2)
    p_spec = SP.param_shardings(cfg, mesh, params)
    o_spec = SP.opt_state_shardings(cfg, mesh, opt, p_spec)
    shardings = {"params": p_spec, "opt": o_spec}
    split = 0
    parts = [CK.restore(str(tmp_path), shardings=shardings, mesh=mesh,
                        rank=r)[0] for r in range(2)]
    for m in ("m", "v"):
        for k, full in opt[m].items():
            spec = o_spec[m][k]
            got = [p["opt"][m][k] for p in parts]
            if "data" not in spec:
                for g in got:
                    assert torch.equal(g, full)
                continue
            split += 1
            dim = spec.index("data")
            assert got[0].shape[dim] * 2 == full.shape[dim]
            assert torch.equal(torch.cat(got, dim), full)
    assert split == 2 * len(opt["m"]) - 2 * sum(
        1 for p in params.values() if all(n % 2 for n in p.shape))
    for k, p in params.items():              # data-parallel: replicated
        assert all(torch.equal(q["params"][k], p) for q in parts)
    assert int(parts[1]["opt"]["step"]) == 0


def _train_digest(capsys, *extra) -> str:
    """`launch/train.py` on the reduced smollm, deterministic: its final
    parameters' sha256."""
    from repro_torch.launch import train as TR
    was = torch.are_deterministic_algorithms_enabled()
    try:
        TR.main(["--arch", "smollm-135m", "--reduced", "--steps", "3",
                 "--device", "cpu", "--deterministic", *extra])
    finally:
        torch.use_deterministic_algorithms(was)
    out = capsys.readouterr().out
    return next(x for x in out.splitlines()
                if x.startswith("params sha256")).split()[2]


def test_train_cli_mesh_same_bits(capsys, monkeypatch):
    """--mesh on the CPU (a 1-device host mesh) ends with the parameters
    of the run without it; a mesh of two devices in one process is
    refused, naming the multi-process path."""
    assert _train_digest(capsys, "--mesh") == _train_digest(capsys)
    from repro_torch.launch import train as TR
    monkeypatch.setattr(TR, "make_host_mesh", lambda n: MS.make_host_mesh(2))
    with pytest.raises(SystemExit):
        TR.main(["--arch", "smollm-135m", "--reduced", "--steps", "1",
                 "--device", "cpu", "--mesh"])
    assert "ddp_shardmap.py" in capsys.readouterr().err
