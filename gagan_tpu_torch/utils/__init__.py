"""Snapshot and config helpers of the port."""
