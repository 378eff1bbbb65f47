"""rwkv6-7b "Finch": attention-free, data-dependent decay
[arXiv:2404.05892].  Sub-quadratic: runs the long_500k cell."""
from . import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,  # head_size 64
    d_ff=14336, vocab=65536, act="relu2", rope="none",
    supports_long_context=True,
    source="arXiv:2404.05892",
))
