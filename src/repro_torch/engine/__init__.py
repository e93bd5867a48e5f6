"""Execution engine of the port (in-core sequential loop in this slice)."""
