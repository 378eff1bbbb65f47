"""The plain reference the benchmark's `correct` is decided by: Python
ints and NumPy only, nothing of the port and nothing of JAX."""
