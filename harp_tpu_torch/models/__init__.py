"""Body models (torch counterparts of harp_tpu.models)."""
