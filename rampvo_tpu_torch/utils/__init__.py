"""Trajectory metrics (port of rampvo_tpu/utils/metrics.py)."""
