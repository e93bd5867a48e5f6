"""Architecture registry: ``--arch <id>`` resolution for every entry point
(the reference's ``repro.models.registry``, resolving to the port's
configs)."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "hymba-1.5b": "hymba_1_5b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "bigmeans_paper": "bigmeans_paper",
}

LM_ARCHS = [a for a in _ARCH_MODULES if a != "bigmeans_paper"]


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(name: str):
    if name not in _ARCH_MODULES:
        # tolerate underscores / module-style ids
        inv = {v: k for k, v in _ARCH_MODULES.items()}
        if name in inv:
            name = inv[name]
        else:
            raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def model_fns(cfg):
    """The module of (forward, prefill, decode_step) for a config."""
    from repro_torch.models import encdec, transformer

    if cfg.family == "encdec":
        return encdec
    return transformer
