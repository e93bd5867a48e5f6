"""Frozen copy of the port's key tree (``repro_torch.random.TorchRNG``).

The benchmark derives its data, its job seeds and, in the reference, the
rows of a fit's winning chunk from ``--seed`` with these functions.  They
are copied, not imported, so that a change to the program's key tree shows
as a failing drift test and never moves the yardstick with it.
"""
from __future__ import annotations

import torch

_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64 finalizer: a bijective avalanche on 64-bit ints."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def key(seed: int) -> int:
    return _mix(int(seed) & _MASK)


def fold_in(k: int, data: int) -> int:
    return _mix(k ^ _mix(int(data) + 1))


def split(k: int, n: int = 2) -> list[int]:
    return [fold_in(k, i) for i in range(n)]


def generator(k: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(k)
    return gen


def randint(k: int, shape, lo: int, hi: int, device) -> torch.Tensor:
    return torch.randint(lo, hi, tuple(shape), generator=generator(k, device),
                         device=device)


# Streams of a run's seed besides its jobs (0, 1, 2, ...).
DATA, CODEBOOK, WARMUP, SAMPLE = ((1 << 40) + i for i in range(4))


def derive(seed: int, stream: int) -> int:
    """The seed of job ``stream`` (or of one of the streams above) of a run
    with ``--seed seed``: a non-negative 63-bit int."""
    return fold_in(key(seed), stream) >> 1
