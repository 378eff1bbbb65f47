"""The language models of every family: `layers` (norms, RoPE/M-RoPE,
GQA attention, MLPs, the cross-entropy), `moe` (top-k capacity
dispatch), `rwkv` (RWKV-6 time and channel mix), `mamba` (the selective
SSM), `transformer` (the model, its training loss, its decode cache,
prefill and decode) and `sharding` (the mesh context and `constrain`,
which the dry run's cost walk observes).  The port of `repro/models/`."""
