"""The loops a mix drives, found by the mix's ``"loop"``: the module
``perfbench/loops/<loop>.py`` and its class ``Loop``.  A loop sets the run
up (data on the card, warm-up), drives the timed window and the traced
jobs, and judges a sample of the window's answers.

This module holds what the loops share (the data, the sample, the base
class); each loop is a file of its own, so a new kind of traffic is a new
file that imports these and edits none:

* ``fit_evaluate`` — a closed loop of jobs: ``repro_torch.api.fit`` over
  the resident rows, then ``repro_torch.api.evaluate`` of its centroids
  over all of them; each job seeded anew from ``--seed``.
* ``evaluate`` — a closed loop of ``repro_torch.api.evaluate`` calls of
  one codebook (``k`` rows of the data, drawn from the seed) over all rows.
"""
from __future__ import annotations

import importlib
import random
import re
import time

import torch

from perfbench.gen import gmm, rng


def find(name: str):
    """The ``Loop`` class of ``perfbench/loops/<name>.py``."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"a loop's name is a module name, not {name!r}")
    return importlib.import_module(f"{__name__}.{name}").Loop


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_data(config: dict, seed: int, device: torch.device):
    """(spec, X [m, n] f32 on the device, true component means).

    The mixture (its means and weights) is the configuration's own, from
    its ``mixture_seed``; the rows drawn from it come from ``seed``.  So
    every seed clusters the same population, in another sample."""
    spec = gmm.GMMSpec(m=config["m"], n=config["n"],
                       components=config["components"],
                       spread=config["spread"], noise=config["noise"],
                       seed=rng.derive(seed, rng.DATA))
    params = gmm.component_params(spec._replace(seed=config["mixture_seed"]),
                                  device)
    X = torch.empty((spec.m, spec.n), dtype=torch.float32, device=device)
    for i, lo in enumerate(range(0, spec.m, gmm.GEN_CHUNK)):
        hi = min(lo + gmm.GEN_CHUNK, spec.m)
        X[lo:hi] = gmm.gmm_chunk(spec, i, gmm.GEN_CHUNK, device=device,
                                 params=params)[: hi - lo]
    return spec, X, params[0]


def true_objective(X: torch.Tensor, means: torch.Tensor) -> float:
    """The objective of the true component means, f(M, X), in float64."""
    mu = means.double()
    mu2 = (mu * mu).sum(1)
    total = 0.0
    for lo in range(0, X.shape[0], 1 << 16):
        x = X[lo:lo + (1 << 16)].double()
        d = (x * x).sum(1, keepdim=True) - 2.0 * (x @ mu.T) + mu2[None, :]
        total += float(d.clamp_min_(0.0).min(1).values.sum())
    return total


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from a seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = size, [], 0
        self._rand = random.Random(seed)

    def offer(self, make):
        """Keep the next item (``make()``, built only if kept) or not."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(make())
        else:
            slot = self._rand.randrange(self.seen)
            if slot < self.size:
                self.items[slot] = make()


class BaseLoop:
    """The data, the judged sample and the window of every loop.  A loop
    adds ``warm()``, ``job() -> record`` (job ``self.count``, which it
    then counts), ``judge() -> numbers`` and ``denominator() -> float |
    None``."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        from repro_torch import api
        from repro_torch.kernels import ops

        self.api, self.ops = api, ops
        self.config, self.mix, self.seed, self.device = (config, mix, seed,
                                                         device)
        self.spec, self.X, self.means = make_data(config, seed, device)
        self.sample = Reservoir(mix["check_jobs"],
                                rng.derive(seed, rng.SAMPLE))
        self.count = 0

    def _device_arg(self):
        return None if self.device.type == "cuda" else str(self.device)

    def evaluate(self, centroids):
        """The program's full-data assignment: (ids, f)."""
        return self.api.evaluate(centroids, self.X,
                                 device=self._device_arg())

    def window(self, seconds: float) -> tuple[list, float]:
        """Jobs back to back, started while under ``seconds``: (records,
        seconds from the first job's start to the last one's end)."""
        records = []
        t0 = time.monotonic()
        while not records or time.monotonic() - t0 < seconds:
            t1 = time.monotonic()
            records.append(self.job())
            records[-1]["job_s"] = time.monotonic() - t1
        return records, time.monotonic() - t0

    def replay(self, index: int) -> dict:
        """Job ``index`` of the window again (the same seed, so the same
        work on the card): its record."""
        count, self.count = self.count, index
        try:
            return self.job()
        finally:
            self.count = count
