"""Out-of-core dataset loaders for the streaming runner.

``MemmapProvider`` serves uniform random chunks from an .npy file without
loading it (the path for the paper's GB-scale datasets); ``csv_to_npy`` is
the one-off ingestion helper (streaming, bounded RAM).  Chunks are sampled
with NumPy's counter-based generator keyed on ``(seed, chunk_id)``, so
restarts replay identical streams.  A copy of the reference's
``repro.data.loader`` (``sharded_provider`` comes with queue 1 item 8).
"""
from __future__ import annotations

import csv as _csv

import numpy as np


class MemmapProvider:
    """provider(chunk_id) -> [s, n] float32, uniform with replacement."""

    def __init__(self, path: str, s: int, *, seed: int = 0,
                 dtype=np.float32):
        self.mm = np.load(path, mmap_mode="r")
        if self.mm.ndim != 2:
            raise ValueError(f"{path}: expected 2-D data, got shape "
                             f"{self.mm.shape}")
        self.s = s
        self.seed = seed
        self.dtype = dtype

    @property
    def shape(self):
        return self.mm.shape

    def __call__(self, chunk_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, chunk_id))
        idx = rng.integers(0, self.mm.shape[0], size=self.s)
        idx.sort()                      # mostly-sequential reads off disk
        return np.asarray(self.mm[idx], dtype=self.dtype)


def csv_to_npy(csv_path: str, npy_path: str, *, skip_header: bool = True,
               usecols=None, batch_rows: int = 65536) -> tuple[int, int]:
    """Stream a numeric CSV into a .npy (two passes, O(batch) RAM).

    Returns (rows, cols).  Use once at ingestion; :class:`MemmapProvider`
    serves the result after.
    """
    with open(csv_path, newline="") as f:       # pass 1: rows and width
        reader = _csv.reader(f)
        if skip_header:
            next(reader)
        first = next(reader)
        cols = len(usecols) if usecols else len(first)
        rows = 1 + sum(1 for _ in reader)

    out = np.lib.format.open_memmap(
        npy_path, mode="w+", dtype=np.float32, shape=(rows, cols))
    with open(csv_path, newline="") as f:
        reader = _csv.reader(f)
        if skip_header:
            next(reader)
        buf, written = [], 0
        for row in reader:
            buf.append([row[i] for i in usecols] if usecols else row)
            if len(buf) >= batch_rows:
                out[written:written + len(buf)] = np.asarray(buf, np.float32)
                written += len(buf)
                buf = []
        if buf:
            out[written:written + len(buf)] = np.asarray(buf, np.float32)
            written += len(buf)
    out.flush()
    if written != rows:
        raise RuntimeError(f"{csv_path}: wrote {written} of {rows} rows")
    return rows, cols
