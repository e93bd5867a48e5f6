"""Workload configurations of the port.

:mod:`repro_torch.configs.bigmeans_paper` — the paper's own Big-means
workload (``CONFIG``), the reference's ``repro.configs.bigmeans_paper``.
The language-model zoo's published configurations, copied unchanged:
:mod:`hymba_1_5b`, :mod:`seamless_m4t_medium`, :mod:`deepseek_moe_16b`,
:mod:`qwen3_moe_235b_a22b`, each a ``CONFIG`` resolved by
``repro_torch.models.registry.get_config``, and :mod:`shapes` (the
assigned input shapes, ``SHAPES``).
"""
