"""Frozen copy of ``repro_torch.data.synthetic``'s mixture generator.

``gmm_chunk`` and ``component_params`` are the program's
``gmm_chunk`` and ``_component_params`` over the frozen key tree
(:mod:`perfbench.gen.rng`); ``gmm_dataset`` materializes the rows on the
device in the program's generation width, so the same spec gives the same
rows as ``repro_torch.data.synthetic.gmm_dataset`` on the same device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.gen import rng


class GMMSpec(NamedTuple):
    m: int
    n: int
    components: int
    spread: float = 5.0
    noise: float = 1.0
    seed: int = 0


GEN_CHUNK = 1 << 16


def component_params(spec: GMMSpec, device):
    """(means [components, n], mixture weights [components])."""
    kmu, kw = rng.split(rng.key(spec.seed))
    means = torch.randn((spec.components, spec.n),
                        generator=rng.generator(kmu, device),
                        device=device) * spec.spread
    logits = torch.rand((spec.components,), generator=rng.generator(kw, device),
                        device=device) - 0.5
    return means, torch.softmax(logits, dim=0)


def gmm_chunk(spec: GMMSpec, chunk_id: int, chunk_size: int, *, device,
              params=None) -> torch.Tensor:
    means, probs = params if params is not None else component_params(
        spec, device)
    root = rng.key(spec.seed + 1)
    kc, kn = rng.split(rng.fold_in(root, chunk_id))
    comp = torch.multinomial(probs, chunk_size, replacement=True,
                             generator=rng.generator(kc, device))
    noise = torch.randn((chunk_size, spec.n),
                        generator=rng.generator(kn, device), device=device)
    return means[comp] + noise * spec.noise


def gmm_dataset(spec: GMMSpec, *, device) -> torch.Tensor:
    """The full [m, n] f32 dataset on ``device``."""
    params = component_params(spec, device)
    out = torch.empty((spec.m, spec.n), dtype=torch.float32, device=device)
    for i, lo in enumerate(range(0, spec.m, GEN_CHUNK)):
        hi = min(lo + GEN_CHUNK, spec.m)
        out[lo:hi] = gmm_chunk(spec, i, GEN_CHUNK, device=device,
                               params=params)[: hi - lo]
    return out
