"""Offset parameterizations of the port (params/offsets.py)."""
