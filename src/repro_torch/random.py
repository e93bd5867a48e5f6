"""Key-tree randomness: ``split``, ``randint``, ``gumbel`` (and ``choice``).

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
* ``key_to_array(key)`` / ``key_from_array(a)`` — the key as the
  ``uint32[2]`` numpy array a checkpoint stores (the reference's
  ``PRNGKey`` leaf), and back.

:class:`TorchRNG` is the package's backend: keys are 64-bit integers,
children are derived with the splitmix64 finalizer, and every draw runs on
the target device through a ``torch.Generator`` seeded from its key.  Its
numbers differ from ``jax.random``'s; the tests plug in a backend that
replays ``jax.random`` through the same interface, so a trajectory can be
held against the reference one decision at a time.
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

    @staticmethod
    def key_to_array(key: int) -> np.ndarray:
        """The 64-bit key as ``uint32[2]``: ``[hi, lo]``."""
        return np.asarray([key >> 32, key & 0xFFFFFFFF], dtype=np.uint32)

    @staticmethod
    def key_from_array(a) -> int:
        a = np.asarray(a)
        return (int(a[0]) << 32) | int(a[1])


TORCH = TorchRNG()
