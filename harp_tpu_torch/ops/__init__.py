"""Numerics, rotations and mesh operators (torch counterparts of harp_tpu.ops)."""
