"""Deterministic synthetic datasets, generated on the device."""
