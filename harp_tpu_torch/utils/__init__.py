"""Checkpoint / result IO, JSONL metrics and profiling, image I/O and visual
outputs, --debug-nans."""
