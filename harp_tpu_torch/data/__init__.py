"""Sequence data (torch counterparts of harp_tpu.data)."""
