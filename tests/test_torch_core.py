"""Parity of the port's core (Lloyd, K-means++, the chunk step) with the
reference, one decision at a time.

Both packages get the same numpy inputs; the port draws its randomness
through the jax-replay backend of ``test_torch_rng``, so K-means++ proposals
and chunk samples are the reference's.  Decisions (iteration counts, ids,
counts, degeneracy, chosen rows, accepts) must be equal; floats differ only
by summation order and are held to ``RTOL``.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.core import bigmeans as jbm
from repro.core import kmeans as jkm
from repro.data.synthetic import GMMSpec, gmm_dataset
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.core import bigmeans, kmeans, kmeanspp
from test_torch_rng import REPLAY

# repro.core re-exports a function named kmeanspp over its submodule
jkpp = importlib.import_module("repro.core.kmeanspp")

RTOL = 1e-5   # f32 results of the same arithmetic in another order

DATA = {n: np.asarray(gmm_dataset(GMMSpec(m=4096, n=n, components=15,
                                          seed=2)))
        for n in (3, 28)}


def t(a):
    return torch.from_numpy(np.array(a))


def assert_state_close(state, jstate):
    c, deg, f, acc, nd = convert.state_to_numpy(state)
    np.testing.assert_array_equal(deg, np.asarray(jstate.degenerate))
    assert int(acc) == int(jstate.n_accepted)
    np.testing.assert_allclose(f, np.asarray(jstate.f_best), rtol=RTOL)
    # n_d: the same f32 formula on equal integers; only rounding may differ
    np.testing.assert_allclose(nd, np.asarray(jstate.n_dist_evals),
                               rtol=1e-6)
    scale = float(np.abs(np.asarray(jstate.centroids)).max())
    np.testing.assert_allclose(c, np.asarray(jstate.centroids), rtol=RTOL,
                               atol=RTOL * scale)


@pytest.mark.parametrize("n", [3, 28])
@pytest.mark.parametrize("max_iters,tol", [(300, 1e-4), (3, 0.0)])
def test_lloyd_matches_reference(n, max_iters, tol):
    X = DATA[n][:2048]
    init = np.asarray(jkpp.kmeanspp(X, jax.random.PRNGKey(n), 15))
    want = jkm.lloyd(X, init, max_iters=max_iters, tol=tol, impl="ref")
    got = kmeans.lloyd(t(X), t(init), max_iters=max_iters, tol=tol,
                       impl="ref")
    assert got.iterations == int(want.iterations)
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(want.assignments))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    np.testing.assert_array_equal(got.degenerate.numpy(),
                                  np.asarray(want.degenerate))
    scale = float(np.abs(np.asarray(want.centroids)).max())
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=RTOL)


def test_lloyd_reports_degenerate_clusters():
    X = DATA[28][:1024]
    init = np.concatenate([X[:4], np.full((1, 28), 1e3, np.float32)])
    want = jkm.lloyd(X, init, impl="ref")
    got = kmeans.lloyd(t(X), t(init), impl="ref")
    assert bool(got.degenerate[4]) and bool(np.asarray(want.degenerate)[4])
    np.testing.assert_array_equal(got.degenerate.numpy(),
                                  np.asarray(want.degenerate))
    np.testing.assert_array_equal(got.centroids[4].numpy(), init[4])
    assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("n", [3, 28])
def test_seed_matches_reference_with_replay(n):
    X = DATA[n][:2048]
    key = jax.random.PRNGKey(10 + n)
    # fresh K-means++: every slot sampled
    want = np.asarray(jkpp.seed(X, key, 15))
    got = kmeanspp.seed(t(X), key, 15, rng=REPLAY).numpy()
    np.testing.assert_array_equal(got, want)        # the same chosen rows
    # re-seeding: surviving rows kept, degenerate ones re-drawn
    deg = np.zeros(15, bool)
    deg[[1, 6, 14]] = True
    want = np.asarray(jkpp.seed(X, key, 15, init=want, degenerate=deg))
    got2 = kmeanspp.seed(t(X), key, 15, init=t(got), degenerate=t(deg),
                         rng=REPLAY).numpy()
    np.testing.assert_array_equal(got2, want)


def test_seed_keeps_rows_and_draws_data_points():
    X = DATA[28][:1024]
    init = np.stack([X[0], X[1], np.zeros(28, np.float32), X[3]])
    deg = np.array([False, False, True, False])
    out = kmeanspp.seed(t(X), rnd.TORCH.key(5), 4, init=t(init),
                        degenerate=t(deg)).numpy()
    np.testing.assert_array_equal(out[[0, 1, 3]], init[[0, 1, 3]])
    assert np.min(np.sum((X - out[2]) ** 2, axis=1)) == 0.0  # a data point


def test_objectives_match_reference():
    from repro.core import objective as jobj
    from repro_torch.core import objective

    X = DATA[28]
    c = X[:15]
    ids, f = objective.full_assignment(t(X), t(c), batch=1000)
    jids, jf = jobj.full_assignment(X, c, batch=1000)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(float(f), float(jf), rtol=RTOL)
    np.testing.assert_allclose(
        float(objective.full_objective(t(X), t(c), batch=1000)), float(jf),
        rtol=RTOL)
    np.testing.assert_allclose(
        float(objective.chunk_objective(t(X[:512]), t(c))),
        float(jobj.chunk_objective(X[:512], c, impl="ref")), rtol=RTOL)


def _jax_states(X, s, n_chunks):
    """The reference's states and infos chunk by chunk, with its key tree."""
    state = jbm.init_state(15, X.shape[1])
    out = []
    for key_i in jax.random.split(jax.random.PRNGKey(0), n_chunks):
        ks, kc = jax.random.split(key_i)
        chunk = np.asarray(jbm.sample_chunk(X, ks, s))
        new, info = jbm.chunk_step(chunk, state, kc, impl="ref")
        out.append((state, chunk, kc, new, info))
        state = new
    return out


@pytest.mark.parametrize("n", [3, 28])
def test_chunk_step_matches_reference(n):
    """The same accept decision and n_d per chunk, with the port started
    from the reference's incumbent (convert.state_from_numpy) each time."""
    steps = _jax_states(DATA[n], 1024, 6)
    assert any(bool(info.accepted) for *_, info in steps)
    assert not all(bool(info.accepted) for *_, info in steps)
    for before, chunk, kc, after, info in steps:
        state = convert.state_from_numpy(
            *(np.asarray(f) for f in before), device="cpu")
        new, got = bigmeans.chunk_step(t(chunk), state, kc, impl="ref",
                                       rng=REPLAY)
        assert bool(got.accepted) == bool(info.accepted)
        assert int(got.lloyd_iters) == int(info.lloyd_iters)
        assert int(got.n_degenerate) == int(info.n_degenerate)
        np.testing.assert_allclose(float(got.f_new), float(info.f_new),
                                   rtol=RTOL)
        assert_state_close(new, after)


def test_sample_chunk_replay_matches_reference():
    X = DATA[28]
    key = jax.random.PRNGKey(3)
    for repl in (True, False):
        want = np.asarray(jbm.sample_chunk(X, key, 512, with_replacement=repl))
        got = bigmeans.sample_chunk(t(X), key, 512, with_replacement=repl,
                                    rng=REPLAY).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", [rnd.TORCH, REPLAY],
                         ids=["torch", "jax-replay"])
def test_sample_chunk_without_replacement_unique(backend):
    rows = torch.arange(1000.0)[:, None]
    out = bigmeans.sample_chunk(rows, backend.key(11), 64,
                                with_replacement=False, rng=backend)
    assert len(np.unique(out.numpy().ravel())) == 64


def test_state_round_trips_through_numpy():
    state = bigmeans.init_state(5, 3, device="cpu")
    back = convert.state_from_numpy(*convert.state_to_numpy(state),
                                    device="cpu")
    for a, b in zip(state, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jstate = jbm.init_state(5, 3)
    for a, b in zip(convert.state_to_numpy(state), jstate):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
