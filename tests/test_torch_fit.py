"""The slice end to end: the port's ``fit`` + ``evaluate`` against the
reference's ``fit(method="sequential", impl="ref")`` + ``evaluate``.

The quick-tier datasets of the reference's evalsuite (``road3d-24k``: n=3,
``hepmass-16k``: n=28, both k=15, s=2048, 24 chunks) are built in numpy and
handed to both packages.  The port runs on the CPU with the jax-replay key
tree, so it must take every decision the reference takes: the same accept
sequence, the same Lloyd iterations per chunk and the same ``n_accepted``.
Objectives and centroids differ only by summation order (``RTOL``).
"""
import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import bigmeans as jbm
from repro.data.synthetic import gmm_dataset
from repro.evalsuite.datasets import get_dataset
from repro_torch import api
from repro_torch.core import bigmeans
from test_torch_rng import REPLAY

RTOL = 1e-5

DATASETS = ("road3d-24k", "hepmass-16k")


@pytest.fixture(scope="module", params=DATASETS)
def case(request):
    spec = get_dataset(request.param)
    X = np.asarray(gmm_dataset(spec.gmm))
    cfg = dict(k=spec.k, s=spec.s, n_chunks=spec.n_chunks)
    want = japi.fit(X, japi.BigMeansConfig(**cfg), method="sequential",
                    impl="ref")
    _, f_full = japi.evaluate(want, X)
    _, infos = jbm.big_means(X, jax.random.PRNGKey(0), impl="ref", **cfg)
    return spec, X, cfg, want, f_full, infos


@pytest.mark.parametrize("method", ["sequential", "auto"])
def test_fit_matches_reference(case, method):
    spec, X, cfg, want, f_full, _ = case
    got = api.fit(X, api.BigMeansConfig(**cfg), method=method,
                  device="cpu", rng=REPLAY)
    assert got.strategy == "sequential"
    assert [a for _, _, a in got.trace] == [a for _, _, a in want.trace]
    assert got.n_accepted == want.n_accepted
    assert got.n_iterations == want.n_iterations
    assert got.n_chunks == want.n_chunks
    np.testing.assert_allclose([f for _, f, _ in got.trace],
                               [f for _, f, _ in want.trace], rtol=RTOL)
    np.testing.assert_allclose(got.objective, want.objective, rtol=RTOL)
    np.testing.assert_allclose(got.n_dist_evals, want.n_dist_evals,
                               rtol=1e-6)
    ref_c = np.asarray(want.centroids)
    np.testing.assert_allclose(got.centroids.numpy(), ref_c, rtol=RTOL,
                               atol=RTOL * float(np.abs(ref_c).max()))
    assert got.extras["fit"]["impl"] == "ref"
    assert got.extras["fit"]["device"] == "cpu"
    assert got.extras.get("auto", False) == (method == "auto")

    ids, f = api.evaluate(got, X, device="cpu")
    jids, _ = japi.evaluate(want, X)
    np.testing.assert_allclose(f, f_full, rtol=RTOL)
    assert ids.shape == (X.shape[0],)
    # ids equal wherever the two solutions' centroids agree (they do here)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    # the quality gap to the dataset's best known objective is the same
    eps, jeps = (f - spec.f_star) / spec.f_star, (f_full - spec.f_star) \
        / spec.f_star
    assert abs(eps - jeps) <= RTOL * f_full / spec.f_star


def test_per_chunk_lloyd_iterations_match_reference(case):
    _, X, cfg, _, _, infos = case
    _, got = bigmeans.big_means(torch.from_numpy(X.copy()), REPLAY.key(0),
                                rng=REPLAY, device="cpu", **cfg)
    np.testing.assert_array_equal(got.lloyd_iters.numpy(),
                                  np.asarray(infos.lloyd_iters))
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(infos.accepted))
    np.testing.assert_array_equal(got.n_degenerate.numpy(),
                                  np.asarray(infos.n_degenerate))


def test_fit_from_npy_path(tmp_path):
    """An .npy path runs in core under method='sequential'; under 'auto' it
    runs the streaming strategy, as the reference's resolve_auto does."""
    spec = get_dataset("road3d-24k")
    X = np.asarray(gmm_dataset(spec.gmm))[:4096]
    path = tmp_path / "x.npy"
    np.save(path, X)
    cfg = api.BigMeansConfig(k=5, s=512, n_chunks=4)
    a = api.fit(str(path), cfg, method="sequential", device="cpu")
    b = api.fit(X, cfg, method="sequential", device="cpu")
    assert torch.equal(a.centroids, b.centroids)
    streamed = api.fit(str(path), cfg, device="cpu")
    assert streamed.strategy == "streaming" and streamed.extras["auto"]
    assert streamed.n_chunks == cfg.n_chunks
    assert np.isfinite(streamed.objective)
    assert streamed.extras["health"]["chunks_fetched"] == cfg.n_chunks


def test_torch_backend_fit_is_deterministic():
    spec = get_dataset("hepmass-16k")
    X = torch.from_numpy(np.array(gmm_dataset(spec.gmm)))
    cfg = api.BigMeansConfig(k=spec.k, s=spec.s, n_chunks=6, seed=3)
    a = api.fit(X, cfg, device="cpu")
    b = api.fit(X, cfg, device="cpu")
    assert torch.equal(a.centroids, b.centroids)
    assert a.trace == b.trace and a.n_accepted >= 1
