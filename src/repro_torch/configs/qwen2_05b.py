"""qwen2-0.5b: GQA with QKV bias [arXiv:2407.10671]."""
from . import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936, act="swiglu", rope="rope",
    qkv_bias=True, tie_embeddings=True,
    source="arXiv:2407.10671",
))
