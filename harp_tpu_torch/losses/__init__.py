"""Fitting losses (torch counterparts of harp_tpu.losses)."""
