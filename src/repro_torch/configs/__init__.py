"""Workload configurations of the port.

:mod:`repro_torch.configs.bigmeans_paper` — the paper's own Big-means
workload (``CONFIG``), the reference's ``repro.configs.bigmeans_paper``.
The reference's language-model configurations are not ported.
"""
