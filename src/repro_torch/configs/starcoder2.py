"""starcoder2-3b: GQA + RoPE [arXiv:2402.19173]."""
from . import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152, act="gelu", rope="rope",
    norm="layernorm", qkv_bias=True,
    source="arXiv:2402.19173",
))
