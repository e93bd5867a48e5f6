"""A closed loop of ``repro_torch.api.evaluate`` calls of one codebook
(``k`` rows of the data, drawn from the seed) over all rows."""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from perfbench.gen import rng
from perfbench.loops import BaseLoop, sync
from perfbench.reference import judge


class Loop(BaseLoop):
    def __init__(self, *args):
        super().__init__(*args)
        gen = rng.generator(rng.derive(self.seed, rng.CODEBOOK), self.device)
        rows = torch.randperm(self.X.shape[0], generator=gen,
                              device=self.device)[: self.config["k"]]
        self.codebook = self.X.index_select(0, rows)

    def call(self):
        self.ops.reset_launch_counts()
        t0 = time.monotonic()
        with record_function("perfbench.evaluate"):
            ids, f = self.evaluate(self.codebook)
            sync(self.device)
        record = {"evaluate_s": time.monotonic() - t0,
                  "rows": self.X.shape[0],
                  "launches": sum(self.ops.launch_counts().values()), "f": f}
        return record, ids

    def warm(self) -> None:
        self.call()

    def job(self) -> dict:
        self.count += 1
        record, ids = self.call()
        self.sample.offer(lambda: (ids, record["f"]))
        return record

    def judge(self) -> dict:
        numbers = {}
        for ids, f in self.sample.items:
            for name, value in judge.judge_evaluate(self.X, self.codebook,
                                                    ids, f).items():
                numbers[name] = max(numbers.get(name, 0.0), value)
        return numbers

    def denominator(self) -> None:
        return None
