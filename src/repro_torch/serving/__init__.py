"""Request batching, the division and modular-arithmetic services, and
the fault-tolerant async frontend over them."""
