"""Weights in the reference .pth layout."""
