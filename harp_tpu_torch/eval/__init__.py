"""Evaluation metrics (harp_tpu/eval/metrics.py)."""
