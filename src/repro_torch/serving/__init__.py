"""Request batching and the division service."""
