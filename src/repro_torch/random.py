"""Key-tree randomness: ``split``, ``randint``, ``gumbel``, ``choice`` and
``categorical``.

The reference draws through ``jax.random``: keys split into children and
every draw is a pure function of ``(key, shape)``.  The port keeps that key
schedule exactly — the same splits at the same places — and draws through a
backend object with this interface:

* ``key(seed)`` — the root key of a run;
* ``split(key, n=2)`` — ``n`` child keys;
* ``fold_in(key, data)`` — the child key for the integer ``data`` (the
  streaming loop's per-chunk keys: ``fold_in(key, chunk_id)``);
* ``randint(key, shape, lo, hi, device)`` — int64 in ``[lo, hi)``;
* ``gumbel(key, shape, device)`` — float32 standard Gumbel noise;
* ``choice(key, n, size, device)`` — ``size`` distinct ints of ``[0, n)``;
* ``categorical(key, logits, size, device)`` — ``size`` int64 draws of
  ``[0, m)`` with probabilities ``softmax(logits)`` (``logits`` [m]);
* ``key_to_array(key)`` / ``key_from_array(a)`` — the key as the
  ``uint32[2]`` numpy array a checkpoint stores (the reference's
  ``PRNGKey`` leaf), and back.

:class:`TorchRNG` is the package's backend: keys are 64-bit integers,
children are derived with the splitmix64 finalizer, and every draw runs on
the target device through a ``torch.Generator`` seeded from its key.  Its
numbers differ from ``jax.random``'s; the tests plug in a backend that
replays ``jax.random`` through the same interface, so a trajectory can be
held against the reference one decision at a time.

``TorchRNG.categorical`` is a different draw with the same distribution as
``jax.random.categorical``: jax takes ``argmax(gumbel([size, m]) +
logits)``, which materializes ``size * m`` noise (a 64,000-row coreset
drawn from 10.5M rows would be 2.7 TB), and ``torch.multinomial`` takes at
most 2^24 categories; here the draw is by inverse CDF, a float64 cumulative
sum of ``exp(logits - max)`` searched by ``size`` uniforms, O(m + size)
memory.  ``seed``'s D² draw (``kmeanspp.py``) stays the Gumbel argmax.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64 finalizer: a bijective avalanche on 64-bit ints."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


class TorchRNG:
    """The package's key-tree backend (see the module docstring)."""

    def key(self, seed: int) -> int:
        return _mix(int(seed) & _MASK)

    def fold_in(self, key: int, data: int) -> int:
        """The child key number ``data``; here ``split(key, n)[i] ==
        fold_in(key, i)``.  A backend that replays ``jax.random`` calls
        its ``fold_in`` and its ``split``, whatever their relation."""
        return _mix(key ^ _mix(int(data) + 1))

    def split(self, key: int, n: int = 2) -> list[int]:
        return [self.fold_in(key, i) for i in range(n)]

    @staticmethod
    def generator(key: int, device) -> torch.Generator:
        """A ``torch.Generator`` on ``device`` seeded from ``key``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(key)
        return gen

    def randint(self, key: int, shape, lo: int, hi: int,
                device) -> torch.Tensor:
        return torch.randint(lo, hi, tuple(shape),
                             generator=self.generator(key, device),
                             device=device)

    def gumbel(self, key: int, shape, device) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator(key, device),
                       device=device, dtype=torch.float32)
        # jax.random.gumbel draws u in [tiny, 1): same support here.
        u.clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def choice(self, key: int, n: int, size: int, device) -> torch.Tensor:
        perm = torch.randperm(n, generator=self.generator(key, device),
                              device=device)
        return perm[:size]

    def categorical(self, key: int, logits: torch.Tensor, size: int,
                    device) -> torch.Tensor:
        logits = logits.to(device=device, dtype=torch.float64)
        cdf = torch.cumsum(torch.exp(logits - torch.max(logits)), 0)
        u = torch.rand(size, generator=self.generator(key, device),
                       device=device, dtype=torch.float64) * cdf[-1]
        # the first index whose cumulative mass exceeds u: a category of
        # zero mass never holds it; a u rounded up to the total mass takes
        # the last category that has any
        idx = torch.searchsorted(cdf, u, right=True)
        return torch.minimum(idx, torch.searchsorted(cdf, cdf[-1:]))

    @staticmethod
    def key_to_array(key: int) -> np.ndarray:
        """The 64-bit key as ``uint32[2]``: ``[hi, lo]``."""
        return np.asarray([key >> 32, key & 0xFFFFFFFF], dtype=np.uint32)

    @staticmethod
    def key_from_array(a) -> int:
        a = np.asarray(a)
        return (int(a[0]) << 32) | int(a[1])


TORCH = TorchRNG()
