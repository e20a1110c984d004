"""Wrappers of the hand-written CUDA kernels (counterparts of
harp_tpu/render/pallas/). Each wrapper launches its kernel on a CUDA tensor,
runs its plain PyTorch version on a CPU tensor, and counts its launches."""
