"""Frozen copy, see vobench/reference/__init__.py."""
