"""Command-line entry points (port of rampvo_tpu/cli/evaluate.py)."""
