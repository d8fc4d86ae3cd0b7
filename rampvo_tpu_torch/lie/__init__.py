"""SE3 operations on raw tensors."""
