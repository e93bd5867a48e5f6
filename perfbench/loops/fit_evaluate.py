"""A closed loop of jobs: ``repro_torch.api.fit`` over the resident rows,
then ``repro_torch.api.evaluate`` of its centroids over all of them; each
job seeded anew from ``--seed``."""
from __future__ import annotations

import time

from torch.profiler import record_function

from perfbench.gen import rng
from perfbench.loops import BaseLoop, sync, true_objective
from perfbench.reference import judge


class Loop(BaseLoop):
    def cfg(self, job_seed: int, n_chunks: int):
        c = self.config
        return self.api.BigMeansConfig(
            k=c["k"], s=c["s"], n_chunks=n_chunks, max_iters=c["max_iters"],
            tol=c["tol"], candidates=c["candidates"],
            precision=self.mix.get("precision", c["precision"]),
            batch=self.mix["batch"], sync_every=self.mix["sync_every"],
            seed=job_seed)

    def fit(self, job_seed: int, n_chunks: int):
        return self.api.fit(self.X, self.cfg(job_seed, n_chunks),
                            method=self.mix["method"],
                            device=self._device_arg())

    def run_job(self, job_seed: int, n_chunks: int):
        ops, dev = self.ops, self.device
        ops.reset_launch_counts()
        t0 = time.monotonic()
        with record_function("perfbench.fit"):
            res = self.fit(job_seed, n_chunks)
            sync(dev)
        t1 = time.monotonic()
        with record_function("perfbench.evaluate"):
            ids, f = self.evaluate(res.centroids)
            sync(dev)
        t2 = time.monotonic()
        record = {"seed": job_seed, "fit_s": t1 - t0, "evaluate_s": t2 - t1,
                  "n_chunks": res.n_chunks, "n_accepted": res.n_accepted,
                  "n_iterations": res.n_iterations,
                  "launches": sum(ops.launch_counts().values()), "f": f}
        return record, res, ids

    def warm(self) -> None:
        self.run_job(rng.derive(self.seed, rng.WARMUP),
                     self.mix["warmup_chunks"])

    def job(self) -> dict:
        job_seed = rng.derive(self.seed, self.count)
        self.count += 1
        record, res, ids = self.run_job(job_seed, self.config["n_chunks"])
        self.sample.offer(lambda: (job_seed, res.centroids, res.objective,
                                   list(res.trace), ids, record["f"]))
        return record

    def judge(self) -> dict:
        numbers = {}
        for job_seed, C, objective, trace, ids, f in self.sample.items:
            got = judge.judge_evaluate(self.X, C, ids, f)
            got.update(judge.judge_fit(
                self.X, C, objective, trace, job_seed=job_seed,
                s=self.config["s"], n_chunks=self.config["n_chunks"]))
            for name, value in got.items():
                numbers[name] = max(numbers.get(name, 0.0), value)
        return numbers

    def denominator(self) -> float:
        return true_objective(self.X, self.means)
