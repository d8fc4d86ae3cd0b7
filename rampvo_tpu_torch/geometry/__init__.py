"""Projective geometry for the patch graph."""
