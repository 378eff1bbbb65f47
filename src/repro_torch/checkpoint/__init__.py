"""Checkpoints: `ckpt` (npz shards and a manifest, atomic rename, one
async save in flight, restore onto any device or, elastic, onto a
mesh's layout)."""
