"""Frozen copy (see the package docstring)."""
