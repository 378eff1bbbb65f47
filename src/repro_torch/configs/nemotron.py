"""nemotron-4-340b: GQA, squared-ReLU MLP [arXiv:2402.16819;
unverified]."""
from . import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000, act="relu2", rope="rope",
    norm="layernorm",
    seq_parallel=True,
    source="arXiv:2402.16819 (unverified)",
))
