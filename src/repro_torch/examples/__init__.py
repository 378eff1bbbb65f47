"""Runnable examples of the port, the counterparts of the JAX package's
`examples/`: `python -m repro_torch.examples.<name> [--device cpu]`
(quickstart, modexp_quickstart, bigint_service, serving_frontend).
Each asserts its answers against Python ints."""
