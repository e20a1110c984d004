"""Checkpoint / result IO, JSONL metrics and profiling, PNG visual outputs."""
