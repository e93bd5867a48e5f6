"""Deterministic synthetic datasets, generated on the device.

Gaussian-mixture surrogates with the paper datasets' (m, n), as in the
reference.  Generation is chunk-streamable: :func:`gmm_chunk` produces the
same rows for a ``(spec, chunk_id)`` however many chunks are made at once,
so :func:`gmm_dataset` (in core) and :func:`gmm_memmap` (an ``.npy`` file
for the streaming strategy) hold the same rows.
The rows are the port's own (``torch.Generator`` on the target device), not
the reference's ``jax.random`` rows: tests that compare the two packages
hand both the same numpy data instead.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch import random as rnd


class GMMSpec(NamedTuple):
    m: int                 # number of points
    n: int                 # feature dimension
    components: int        # true mixture components
    spread: float = 5.0    # component-mean scale relative to unit noise
    noise: float = 1.0
    seed: int = 0


def _component_params(spec: GMMSpec, device):
    gen = rnd.TORCH.generator
    kmu, kw = rnd.TORCH.split(rnd.TORCH.key(spec.seed))
    means = torch.randn((spec.components, spec.n), generator=gen(kmu, device),
                        device=device) * spec.spread
    logits = torch.rand((spec.components,), generator=gen(kw, device),
                        device=device) - 0.5
    return means, torch.softmax(logits, dim=0)


def gmm_chunk(spec: GMMSpec, chunk_id: int, chunk_size: int, *, device=None,
              params=None) -> torch.Tensor:
    """Rows [chunk_id*chunk_size, ...) of the virtual dataset: [size, n]."""
    dev = devices.resolve(device)
    means, probs = params if params is not None else _component_params(spec,
                                                                       dev)
    root = rnd.TORCH.key(spec.seed + 1)
    kc, kn = rnd.TORCH.split(rnd.TORCH.fold_in(root, chunk_id))
    gen = rnd.TORCH.generator
    comp = torch.multinomial(probs, chunk_size, replacement=True,
                             generator=gen(kc, dev))
    noise = torch.randn((chunk_size, spec.n), generator=gen(kn, dev),
                        device=dev)
    return means[comp] + noise * spec.noise


# Generation width: rows depend on it, so every materializer uses it.
_GEN_CHUNK = 1 << 16


def gmm_dataset(spec: GMMSpec, *, device=None) -> torch.Tensor:
    """Materialize the full [m, n] f32 dataset on ``device``."""
    dev = devices.resolve(device)
    params = _component_params(spec, dev)
    out = torch.empty((spec.m, spec.n), dtype=torch.float32, device=dev)
    for i, lo in enumerate(range(0, spec.m, _GEN_CHUNK)):
        hi = min(lo + _GEN_CHUNK, spec.m)
        out[lo:hi] = gmm_chunk(spec, i, _GEN_CHUNK, device=dev,
                               params=params)[: hi - lo]
    return out


def gmm_memmap(spec: GMMSpec, path: str, *, device=None) -> str:
    """Write the dataset to an on-disk ``.npy`` file, one generation chunk
    at a time (bounded host memory), through
    ``np.lib.format.open_memmap``.  The rows are generated on ``device``
    exactly as :func:`gmm_dataset` generates them there, so the file holds
    byte for byte the rows of the in-core dataset.  Returns ``path``."""
    dev = devices.resolve(device)
    params = _component_params(spec, dev)
    out = np.lib.format.open_memmap(
        path, mode="w+", dtype=np.float32, shape=(spec.m, spec.n))
    for i, lo in enumerate(range(0, spec.m, _GEN_CHUNK)):
        hi = min(lo + _GEN_CHUNK, spec.m)
        out[lo:hi] = gmm_chunk(spec, i, _GEN_CHUNK, device=dev,
                               params=params)[: hi - lo].cpu().numpy()
    out.flush()
    del out
    return path


# (m, n) signatures of the paper's datasets (Table 1), used as surrogate
# shapes — a copy of the reference's table.
PAPER_DATASETS: dict[str, tuple[int, int]] = {
    "cord19": (599616, 768),
    "hepmass": (10500000, 28),
    "uscensus": (2458285, 68),
    "gisette": (13500, 5000),
    "music": (106574, 518),
    "protein": (145751, 74),
    "miniboone": (130064, 50),
    "mfcc": (85134, 58),
    "isolet": (7797, 617),
    "sensorless": (58509, 48),
    "news": (39644, 58),
    "gas": (13910, 128),
    "road3d": (434874, 3),
    "kegg": (53413, 20),
    "skin": (245057, 3),
    "shuttle": (58000, 9),
    "eeg": (14980, 14),
    "pla85900": (85900, 2),
    "d15112": (15112, 2),
}


def paper_surrogate(name: str, *, scale: float = 1.0, components: int = 25,
                    seed: int = 0, device=None
                    ) -> tuple[GMMSpec, torch.Tensor]:
    """GMM surrogate with the paper dataset's aspect (m scaled, n exact)."""
    m, n = PAPER_DATASETS[name]
    m = max(int(m * scale), 1024)
    spec = GMMSpec(m=m, n=n, components=components, seed=seed)
    return spec, gmm_dataset(spec, device=device)
