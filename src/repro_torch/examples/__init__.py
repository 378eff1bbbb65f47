"""Runnable examples of the port, the counterparts of the JAX package's
`examples/`: `python -m repro_torch.examples.<name> [--device cpu]`
(quickstart, modexp_quickstart, bigint_service, serving_frontend,
long_context_rwkv, e2e_train).  The big-integer examples assert their
answers against Python ints; e2e_train asserts that its loss falls."""
