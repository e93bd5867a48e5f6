"""Competitor algorithms from the paper's §5 (the reference's
``repro.core.baselines``), on tensors on the card or the CPU.

Each takes the reference's arguments plus ``rng``, the key-tree backend of
:mod:`repro_torch.random`; the same keys are split at the same places.
"""
from repro_torch.core.baselines.coreset import lightweight_coreset_kmeans
from repro_torch.core.baselines.da_mssc import da_mssc
from repro_torch.core.baselines.forgy import forgy_kmeans
from repro_torch.core.baselines.kmeans_parallel import kmeans_parallel
from repro_torch.core.baselines.multistart import multistart_kmeans
from repro_torch.core.baselines.ward import ward

__all__ = [
    "forgy_kmeans",
    "multistart_kmeans",
    "kmeans_parallel",
    "lightweight_coreset_kmeans",
    "da_mssc",
    "ward",
]
