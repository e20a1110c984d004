"""CUDA sources of the port's kernels and their nvcc/ctypes loader (build.py)."""
