"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM
(NVIDIA's data sheet, dense, at 700 W) and the operations and bytes the
step needs, as functions of a cell's shapes and its configuration's raster
capacities (counts.py), whatever code does the work."""

PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12
PEAK_BF16_S = 989e12
