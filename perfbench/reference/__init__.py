"""The plain reference that decides ``correct``: plain PyTorch, imports
nothing of ``repro_torch`` (nor ``jax`` or ``repro``), and works everything
out again from the inputs the benchmark made."""
