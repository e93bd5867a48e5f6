"""The plain reference against NumPy at tiny sizes, and the work counts
against hand counts."""
import math

import numpy as np
import pytest
import torch

from perfbench.gen import rng
from perfbench.gen import roofline as rl
from perfbench.reference import judge, plain


def _data(seed=0, m=900, n=6, k=7):
    g = np.random.default_rng(seed)
    X = g.normal(size=(m, n)).astype(np.float32) * 3
    C = g.normal(size=(k, n)).astype(np.float32) * 3
    return X, C


def _np_dist(X, C):
    X, C = X.astype(np.float64), C.astype(np.float64)
    return ((X[:, None, :] - C[None, :, :]) ** 2).sum(2)


def test_judge_evaluate_against_numpy():
    X, C = _data()
    d = _np_dist(X, C)
    ids = d.argmin(1)
    ids[5] = (ids[5] + 1) % C.shape[0]          # one row sent astray
    f = float(d.min(1).sum()) * (1 + 3e-6)
    got = judge.judge_evaluate(torch.from_numpy(X), torch.from_numpy(C),
                               torch.from_numpy(ids), f)
    scale = d.min(1).sum() / X.shape[0]
    gap = (d[np.arange(len(ids)), ids] - d.min(1)).max()
    assert got["ids_gap"] == pytest.approx(gap / scale, rel=1e-9)
    assert got["f_eval_rel"] == pytest.approx(3e-6, rel=1e-6)


def test_judge_evaluate_refuses_malformed_ids():
    X, C = _data()
    tx, tc = torch.from_numpy(X), torch.from_numpy(C)
    for ids in (torch.zeros(X.shape[0] - 1, dtype=torch.int32),
                torch.full((X.shape[0],), C.shape[0], dtype=torch.int32),
                torch.zeros(X.shape[0], dtype=torch.float32)):
        assert math.isinf(judge.judge_evaluate(tx, tc, ids, 1.0)["ids_gap"])


def test_judge_fit_against_numpy():
    X, _ = _data(m=4000, n=5)
    seed, s, n_chunks = 2**34 + 1, 600, 4
    rows = judge.chunk_rows(seed, 2, m=4000, s=s, n_chunks=n_chunks,
                            device="cpu").numpy()
    P = X[rows].astype(np.float64)
    C = P[:9].astype(np.float32) + 0.25
    d = _np_dist(P, C)
    ids = d.argmin(1)
    f = d.min(1).sum()
    res = 0.0
    for j in range(C.shape[0]):
        members = P[ids == j]
        if len(members):
            res += len(members) * ((C[j] - members.mean(0)) ** 2).sum()
    obj = float(f * (1 - 2e-6))
    trace = [(0, obj + 5.0, True), (1, obj + 6.0, False), (2, obj, True),
             (3, obj + 0.5, False)]
    got = judge.judge_fit(torch.from_numpy(X), torch.from_numpy(C),
                          obj, trace, job_seed=seed, s=s,
                          n_chunks=n_chunks)
    assert got["accept_violations"] == 0
    assert got["f_chunk_rel"] == pytest.approx(2e-6, rel=1e-6)
    assert got["lloyd_residual"] == pytest.approx(res / f, rel=1e-9)


def test_judge_fit_without_an_accepted_chunk_fails():
    X, C = _data()
    # the rule keeps a first chunk with a finite objective
    got = judge.judge_fit(torch.from_numpy(X), torch.from_numpy(C), 1.0,
                          [(0, 1.0, False)], job_seed=1, s=100, n_chunks=1)
    assert got["accept_violations"] == 1
    got = judge.judge_fit(torch.from_numpy(X), torch.from_numpy(C), 1.0,
                          [], job_seed=1, s=100, n_chunks=1)
    assert got["accept_violations"] == 2
    assert math.isinf(got["lloyd_residual"])


@pytest.mark.parametrize("trace,objective,winner,violations", [
    ([(0, 5.0, True), (1, 6.0, False), (2, 4.0, True)], 4.0, 2, 0),
    # every chunk kept, a worse one too
    ([(0, 5.0, True), (1, 6.0, True), (2, 4.0, True)], 4.0, 2, 1),
    # a better chunk rejected, and a worse one after it
    ([(0, 5.0, True), (1, 4.0, False), (2, 6.0, False)], 5.0, 1, 2),
    # a tie is not kept
    ([(0, 5.0, True), (1, 5.0, True), (2, 6.0, False)], 5.0, 0, 1),
    # the objective of another chunk returned
    ([(0, 5.0, True), (1, 6.0, False), (2, 4.0, True)], 6.0, 2, 1),
    # a chunk missing; chunks out of order
    ([(0, 5.0, True), (2, 4.0, True)], 4.0, 2, 1),
    ([(1, 5.0, True), (0, 4.0, True), (2, 6.0, False)], 4.0, 0, 1),
    # the program's other events are left out
    ([("ckpt_fallback", 1), (0, 5.0, True), (1, 6.0, False),
      (2, 4.0, True)], 4.0, 2, 0),
])
def test_accept_rule_counts_each_break(trace, objective, winner, violations):
    assert judge.accept_rule(trace, objective, 3) == (winner, violations)


def test_judge_fit_checks_the_rules_winner_not_the_claimed_one():
    X, _ = _data(m=4000, n=5)
    seed, s, n_chunks = 2**34 + 5, 600, 3
    rows = judge.chunk_rows(seed, 0, m=4000, s=s, n_chunks=n_chunks,
                            device="cpu").numpy()
    C = X[rows[:4]]
    d = _np_dist(X[rows], C).min(1).sum()
    # chunk 2 claimed kept with a worse objective, and its centroids sent
    trace = [(0, d, True), (1, d + 1.0, False), (2, d + 2.0, True)]
    got = judge.judge_fit(torch.from_numpy(X), torch.from_numpy(C), d + 2.0,
                          trace, job_seed=seed, s=s, n_chunks=n_chunks)
    assert got["accept_violations"] == 2
    assert got["f_chunk_rel"] > 1e-9


def test_true_objective_against_numpy():
    X, C = _data(m=3000)
    expect = _np_dist(X, C).min(1).sum()
    assert judge.true_objective64(torch.from_numpy(X),
                                  torch.from_numpy(C)) == \
        pytest.approx(expect, rel=1e-12)
    rel = judge.denominator_rel(torch.from_numpy(X), torch.from_numpy(C),
                                expect * (1 + 1e-8))["denominator_rel"]
    assert rel == pytest.approx(1e-8, rel=1e-4)


def test_tf32_rounding_against_numpy():
    x = np.random.default_rng(1).normal(size=4096).astype(np.float32)
    got = plain._round_tf32(torch.from_numpy(x)).numpy()
    bits = x.view(np.uint32).astype(np.uint64)
    want = ((bits + 0x0FFF + ((bits >> 13) & 1)) & ~np.uint64(0x1FFF))
    assert np.array_equal(got.view(np.uint32), want.astype(np.uint32))
    assert np.all(np.abs(got - x) <= np.abs(x) * 2.0 ** -11)


def test_plain_big_means_at_f32_passes_its_judge():
    X = torch.from_numpy(_data(m=6000, n=4)[0])
    C, f, trace = plain.big_means(X, k=5, s=800, n_chunks=3, seed=7,
                                  precision="f32")
    fit = judge.judge_fit(X, C, f, trace, job_seed=7, s=800, n_chunks=3)
    ids, fe = plain.evaluate(X, C, "f32")
    ev = judge.judge_evaluate(X, C, ids, fe)
    assert fit["f_chunk_rel"] < 1e-5 and fit["lloyd_residual"] < 1e-4
    assert ev["ids_gap"] < 1e-5 and ev["f_eval_rel"] < 1e-5


def test_work_counts_against_hand_counts():
    s, n, k = 16_384, 1_024, 2_048
    flops, nbytes = rl.lloyd_iteration_work(s, n, k)
    assert flops == 2 * s * k * n + 3 * s * k + s * n
    assert nbytes == s * n * 4 + 2 * 4 * k * n + 4 * k
    a_flops, a_bytes = rl.assign_work(1_048_576, n, k)
    assert a_flops == 2 * 1_048_576 * k * n + 3 * 1_048_576 * k
    assert a_bytes == 1_048_576 * n * 4 + k * n * 4 + 1_048_576 * 8
    peak = rl.COMPUTE_PEAK["f32"]
    assert peak == 989e12 / 3
    # compute-bound at the codebook shapes: 2skn / peak per iteration
    it = rl.least_seconds(flops, nbytes, peak)
    assert it == pytest.approx(flops / peak)
    assert rl.fit_least_seconds(s=s, n=n, k=k, n_chunks=2, n_iterations=5,
                                peak_flops=peak) == pytest.approx(
        5 * it + 2 * (rl.least_seconds(*rl.assign_work(s, n, k), peak)
                      + rl.least_seconds(s * n, s * n * 4 + 4 * s
                                         + 4 * k * n + 4 * k, peak)))
    # memory-bound at the HEPMASS shapes
    f2, b2 = rl.assign_work(10_500_000, 28, 25)
    assert rl.least_seconds(f2, b2, peak) == pytest.approx(b2 / rl.HBM_BW)


def test_job_seeds_are_distinct_and_non_negative():
    seeds = [rng.derive(2**31 + 77, j) for j in range(1000)]
    streams = [rng.derive(2**31 + 77, s) for s in
               (rng.DATA, rng.CODEBOOK, rng.WARMUP, rng.SAMPLE)]
    assert len(set(seeds + streams)) == 1004
    assert all(0 <= s < 2**63 for s in seeds + streams)
