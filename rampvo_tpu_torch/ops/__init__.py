"""Correlation, scatter and neighbour ops and the Hopper kernels."""
