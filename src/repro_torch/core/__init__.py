"""Limb format, limb primitives and shifted-inverse division."""
