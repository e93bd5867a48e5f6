"""Examples of the port that are package modules, so that its rules (no
``jax``, no ``repro``, the card unless the CPU is asked for) cover them:
:mod:`repro_torch.examples.embedding_clustering`."""
