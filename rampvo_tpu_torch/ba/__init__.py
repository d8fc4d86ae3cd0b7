"""Inference bundle adjustment over the edge lattice."""
