"""Data sources: one protocol over "array here, provider there".

The reference's :class:`DataSource` protocol: a source exposes the in-core
view (``as_array()``) where it can and the streaming view
(``provider(s, seed)``, a ``chunk_id -> [s, n]`` fetcher) everywhere, so
the execution strategy is a config knob, not a calling convention.

Chunk sampling uses the reference's counter-based scheme everywhere (NumPy
``default_rng((seed, chunk_id))`` over row indices, with or without
replacement, indices sorted): :class:`ArraySource` and
:class:`MemmapSource` over the same rows serve byte-identical chunks —
the reference's chunks for the same ``(seed, chunk_id)`` — and restarts
replay identical streams.

``provider(..., dtype=...)``: an explicit dtype wins, ``None`` serves the
source's native default (float32, the file's dtype for memmaps).  Chunks
are numpy arrays.  Unlike the reference, the streaming strategy never asks
a source for bf16 chunks (numpy has no bf16 without ``ml_dtypes``): it
casts f32 chunks to bf16 in torch on the host, in the prefetch thread
(:mod:`repro_torch.engine.stream`).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Iterable, Protocol

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.engine.stream import EndOfStream


class DataSource(Protocol):
    """What a strategy needs from data: feature count + one or both views."""

    @property
    def n_features(self) -> int: ...

    @property
    def n_rows(self) -> int | None: ...

    @property
    def in_core(self) -> bool: ...

    @property
    def prefers_streaming(self) -> bool: ...

    @property
    def data_dtype(self) -> torch.dtype:
        """The dtype the fit reads the data as ('auto' precision follows
        it)."""
        ...

    def as_array(self):
        """The full dataset as a 2-D array or tensor (in-core strategies)."""
        ...

    def provider(self, s: int, *, seed: int = 0,
                 with_replacement: bool = True,
                 dtype=None) -> Callable[[int], np.ndarray]:
        """A ``chunk_id -> [s, n]`` fetcher (streaming strategy)."""
        ...


class _SourceBase:
    prefers_streaming = False
    in_core = True
    n_rows: int | None = None
    data_dtype = torch.float32

    def as_array(self):
        raise TypeError(
            f"{type(self).__name__} cannot be materialized in-core; use the "
            "'streaming' strategy (or 'auto', which picks it)")

    @staticmethod
    def _uniform_chunk_ids(m: int, s: int, seed: int, chunk_id: int,
                           with_replacement: bool = True) -> np.ndarray:
        rng = np.random.default_rng((seed, chunk_id))
        if with_replacement:
            idx = rng.integers(0, m, size=s)
        else:
            idx = rng.choice(m, size=s, replace=False)
        # Canonical (sorted) row order: mostly-sequential reads off disk for
        # memmaps, and byte-identical chunks across adapters over equal rows.
        idx.sort()
        return idx


class ArraySource(_SourceBase):
    """In-core array (numpy or torch, on any device).  numpy has no bf16,
    so a bf16 dataset is a ``torch.bfloat16`` tensor: it stays bf16, and
    ``'auto'`` precision runs it at ``'bf16'``."""

    def __init__(self, X):
        if getattr(X, "ndim", None) != 2:
            raise ValueError(f"expected a 2-D array, got shape "
                             f"{getattr(X, 'shape', None)!r}")
        self.X = X

    @property
    def n_features(self) -> int:
        return self.X.shape[1]

    @property
    def n_rows(self) -> int:
        return self.X.shape[0]

    @property
    def data_dtype(self) -> torch.dtype:
        return devices.data_dtype(self.X)

    def as_array(self):
        return self.X

    def provider(self, s: int, *, seed: int = 0, with_replacement: bool = True,
                 dtype=None):
        X = self.X
        m = X.shape[0]
        dtype = np.float32 if dtype is None else dtype

        def fetch(chunk_id: int) -> np.ndarray:
            idx = self._uniform_chunk_ids(m, s, seed, chunk_id,
                                          with_replacement)
            if isinstance(X, torch.Tensor):
                rows = X.index_select(0, torch.from_numpy(idx).to(X.device))
            else:
                rows = X[idx]
            return devices.host_array(rows, dtype)

        return fetch


class MemmapSource(_SourceBase):
    """An ``.npy`` file served through ``np.memmap``: never fully loaded on
    the streaming path, which ``'auto'`` picks for it; ``as_array`` loads
    it, for the in-core strategies and :func:`repro_torch.api.evaluate`."""

    prefers_streaming = True

    def __init__(self, path: str | os.PathLike, *, dtype=np.float32):
        self.path = os.fspath(path)
        self.dtype = dtype
        self.mm = np.load(self.path, mmap_mode="r")
        if self.mm.ndim != 2:
            raise ValueError(f"{self.path}: expected 2-D data, got shape "
                             f"{self.mm.shape}")

    @property
    def n_features(self) -> int:
        return self.mm.shape[1]

    @property
    def n_rows(self) -> int:
        return self.mm.shape[0]

    def as_array(self):
        return np.asarray(self.mm, dtype=self.dtype)

    def provider(self, s: int, *, seed: int = 0, with_replacement: bool = True,
                 dtype=None):
        mm = self.mm
        m = mm.shape[0]
        dtype = self.dtype if dtype is None else dtype

        def fetch(chunk_id: int) -> np.ndarray:
            idx = self._uniform_chunk_ids(m, s, seed, chunk_id,
                                          with_replacement)
            return np.asarray(mm[idx], dtype=dtype)

        return fetch


class ProviderSource(_SourceBase):
    """A user ``chunk_id -> [s, n]`` callable (the runner's native contract;
    arrays or tensors).

    ``n_features`` is probed from chunk 0 if not given, and the probed
    chunk is served as chunk 0 (the provider may be expensive or
    non-idempotent).  The callable owns the chunk size; the config's ``s``
    should match what it serves.
    """

    prefers_streaming = True
    in_core = False

    def __init__(self, fn: Callable[[int], Any], *,
                 n_features: int | None = None, n_rows: int | None = None):
        self.fn = fn
        self._n_features = n_features
        self.n_rows = n_rows
        self._probe: np.ndarray | None = None

    @property
    def n_features(self) -> int:
        if self._n_features is None:
            probe = devices.host_array(self.fn(0), None)
            if probe.ndim != 2:
                raise ValueError(
                    f"provider returned shape {probe.shape}; expected [s, n]")
            self._probe = probe
            self._n_features = int(probe.shape[1])
        return self._n_features

    def provider(self, s: int, *, seed: int = 0, with_replacement: bool = True,
                 dtype=None):
        dtype = np.float32 if dtype is None else dtype

        # the callable owns chunk contents; sampling knobs don't apply
        def fetch(chunk_id: int) -> np.ndarray:
            if chunk_id == 0 and self._probe is not None:
                out, self._probe = self._probe, None
                return np.asarray(out, dtype=dtype)
            return devices.host_array(self.fn(chunk_id), dtype)

        return fetch


class IteratorSource(_SourceBase):
    """A stream of ``[s, n]`` chunks (generator, DataLoader, socket...).

    Chunks are consumed in order; a small reorder cache absorbs the
    out-of-order ids a prefetch queue may request.  One-shot: a second fit
    over the same iterator continues where the first stopped.  When the
    stream runs dry before the chunk budget, the run ends cleanly
    (:class:`EndOfStream`) instead of counting phantom fetch failures.
    """

    prefers_streaming = True
    in_core = False

    def __init__(self, chunks: Iterable, *, n_features: int | None = None):
        self._it = iter(chunks)
        self._cache: dict[int, np.ndarray] = {}
        self._next_seq = 0
        self._n_features = n_features

    @property
    def n_features(self) -> int:
        if self._n_features is None:
            first = devices.host_array(next(self._it), None)
            self._cache[self._next_seq] = first
            self._next_seq += 1
            self._n_features = int(first.shape[1])
        return self._n_features

    def provider(self, s: int, *, seed: int = 0, with_replacement: bool = True,
                 dtype=None):
        dtype = np.float32 if dtype is None else dtype

        def fetch(chunk_id: int) -> np.ndarray:
            while chunk_id not in self._cache:
                try:
                    self._cache[self._next_seq] = devices.host_array(
                        next(self._it), None)
                except StopIteration:
                    raise EndOfStream(
                        f"chunk stream exhausted before chunk {chunk_id}"
                    ) from None
                self._next_seq += 1
            return np.asarray(self._cache.pop(chunk_id), dtype=dtype)

        return fetch


def as_source(data: Any, *, n_features: int | None = None) -> DataSource:
    """Coerce anything reasonable into a :class:`DataSource`.

    * a source — passed through;
    * ``str`` / ``os.PathLike`` (an ``.npy`` path) — :class:`MemmapSource`;
    * a 2-D numpy array or torch tensor — :class:`ArraySource`;
    * a callable — :class:`ProviderSource`;
    * an iterable / iterator of chunks — :class:`IteratorSource`.
    """
    if isinstance(data, _SourceBase):
        return data
    if isinstance(data, (str, os.PathLike)):
        return MemmapSource(data)
    if isinstance(data, (np.ndarray, torch.Tensor)):
        return ArraySource(data)
    if callable(data):
        return ProviderSource(data, n_features=n_features)
    if hasattr(data, "__iter__") or hasattr(data, "__next__"):
        return IteratorSource(data, n_features=n_features)
    raise TypeError(
        f"cannot build a DataSource from {type(data).__name__}; pass an "
        "array, a tensor, an .npy path, a provider(chunk_id) callable or an "
        "iterator of chunks")
