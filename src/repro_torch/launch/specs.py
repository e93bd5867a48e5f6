"""Abstract inputs and their specs for every (arch x shape) cell, the
reference's ``repro.launch.specs``.

``input_specs`` returns ``meta`` tensors where the reference returns
``ShapeDtypeStruct``s: shapes and dtypes, no storage.  ``batch_sharding``,
``cache_shardings`` and ``input_shardings`` map them onto a mesh: one spec
a leaf (a tuple of physical axes a dim, what the reference's
``NamedSharding`` holds as its ``PartitionSpec``), by the reference's
rules; ``train.sharding.placements`` turns a spec into DTensor
placements.  Modality frontends are stubs: precomputed patch / frame
embeddings appear directly as inputs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.train import sharding as sh


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def text_len(cfg, seq_len: int) -> int:
    """VLM cells split the assigned seq_len into image prefix + text."""
    if cfg.family == "vlm":
        return seq_len - cfg.frontend_len
    return seq_len


def input_specs(cfg, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    St = text_len(cfg, S)
    frontend = (B, cfg.frontend_len, cfg.frontend_dim)
    if shape.kind == "train":
        specs = {"tokens": _meta((B, St), torch.int32),
                 "labels": _meta((B, St), torch.int32)}
        if cfg.frontend:
            specs["frontend"] = _meta(frontend, torch.bfloat16)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": _meta((B, St), torch.int32)}
        if cfg.frontend:
            specs["frontend"] = _meta(frontend, torch.bfloat16)
        return specs
    if shape.kind == "decode":
        cache = T.abstract_cache(
            cfg, B, S,
            enc_len=cfg.frontend_len if cfg.cross_attention else None)
        return {"cache": cache,
                "token": _meta((B, 1), torch.int32),
                "pos": _meta((), torch.int32)}
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------
def batch_sharding(mesh, spec_tree):
    """Shard dim 0 (global batch) over the batch axes where divisible."""
    if isinstance(spec_tree, dict):
        return {k: batch_sharding(mesh, v) for k, v in spec_tree.items()}
    shape = tuple(spec_tree.shape)
    logical = ("batch",) + (None,) * (len(shape) - 1)
    return sh.spec(mesh, *logical, shape=shape)


def cache_shardings(mesh, cache_spec: dict) -> dict:
    """KV / SSM cache: batch over the data axes; if the batch does not
    divide them (B = 1, long context), the *sequence* dim instead
    (flash-decoding style); heads / channels over the model axis where
    they divide it."""
    return {name: cache_shardings(mesh, leaf) if isinstance(leaf, dict)
            else sh.cache_spec(mesh, name, tuple(leaf.shape))
            for name, leaf in cache_spec.items()}


def input_shardings(mesh, cfg, shape: ShapeSpec, specs: dict) -> dict:
    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache_shardings(mesh, v)
        elif k == "pos":
            out[k] = ()
        else:
            out[k] = batch_sharding(mesh, v)
    return out
