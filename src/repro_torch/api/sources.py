"""Data sources: in-core arrays and ``.npy`` files.

The reference's :class:`DataSource` protocol, restricted to what this slice
runs: the in-core view (``as_array``).  Provider callables and chunk
iterators, and the streaming ``provider()`` view, come with the streaming
strategy (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import os
from typing import Any, Protocol

import numpy as np
import torch

from repro_torch import device as devices


class DataSource(Protocol):
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
        """The dtype the in-core loops read the data as ('auto'
        precision follows it)."""
        ...

    def as_array(self):
        """The full dataset as a 2-D array or tensor."""
        ...


class ArraySource:
    """In-core array (numpy or torch).  numpy has no bf16, so a bf16
    dataset is a ``torch.bfloat16`` tensor: it stays bf16, and ``'auto'``
    precision runs it at ``'bf16'``."""

    prefers_streaming = False
    in_core = True

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


class MemmapSource:
    """An ``.npy`` file through ``np.memmap``.  Like the reference it prefers
    streaming (so ``method='auto'`` asks for the unported streaming
    strategy); ``method='sequential'`` loads it in core."""

    prefers_streaming = True
    in_core = True

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

    @property
    def data_dtype(self) -> torch.dtype:
        return torch.float32            # as_array() is a numpy array

    def as_array(self):
        return np.asarray(self.mm, dtype=self.dtype)


def as_source(data: Any) -> DataSource:
    """Coerce an array / tensor or an ``.npy`` path into a source."""
    if isinstance(data, (ArraySource, MemmapSource)):
        return data
    if isinstance(data, (str, os.PathLike)):
        return MemmapSource(data)
    if isinstance(data, (np.ndarray, torch.Tensor)):
        return ArraySource(data)
    if callable(data) or hasattr(data, "__iter__") \
            or hasattr(data, "__next__"):
        raise NotImplementedError(
            "provider callables and chunk iterators are not ported yet "
            "(ROADMAP queue 1 item 6, the streaming strategy)")
    raise TypeError(
        f"cannot build a DataSource from {type(data).__name__}; pass an "
        "array, a tensor or an .npy path")
