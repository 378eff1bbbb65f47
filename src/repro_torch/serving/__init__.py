"""Request batching, the division service and the modular-arithmetic
service."""
