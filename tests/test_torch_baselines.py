"""Parity of the port's §5 baselines and weighted path with the reference.

Both packages get the same numpy inputs; the port draws through the
jax-replay backend of ``test_torch_rng``, so every choice, randint and
categorical draw is the reference's.  Decisions (iterations, ids, chosen
rows, unweighted counts, Ward's labels) must be equal; floats differ only
by summation order and are held to ``RTOL``.  The data and kwargs are
``tests/test_baselines.py``'s and ``tests/test_api.py``'s.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro.api as japi
from repro.core import baselines as jbase
from repro.core import big_means as j_big_means
from repro.core import kmeans as jkm
from repro.data import normalize as jnorm
from repro.data.synthetic import GMMSpec, gmm_dataset
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import api
from repro_torch import random as rnd
from repro_torch.core import baselines as tbase
from repro_torch.core import big_means, full_objective, kmeans, kmeanspp
from repro_torch.data import normalize
from repro_torch.kernels import ops, ref
from test_torch_rng import REPLAY

# repro.core re-exports a function named kmeanspp over its submodule
jkpp = importlib.import_module("repro.core.kmeanspp")

RTOL = 1e-5   # f32 results of the same arithmetic in another order

X = np.asarray(gmm_dataset(GMMSpec(m=5000, n=10, components=6, seed=21)))
KEY = 0

# tests/test_api.py's facade data and config
X_API = np.asarray(gmm_dataset(GMMSpec(m=6000, n=8, components=5, seed=33)))
CFG = dict(k=5, s=500, n_chunks=8, impl="ref", seed=3)

# (reference function, port function, kwargs) as tests/test_baselines.py
LLOYD_BASELINES = {
    "forgy": (jbase.forgy_kmeans, tbase.forgy_kmeans, {}),
    "multistart": (jbase.multistart_kmeans, tbase.multistart_kmeans,
                   {"n_init": 2}),
    "kmeans_parallel": (jbase.kmeans_parallel, tbase.kmeans_parallel,
                        {"rounds": 3}),
    "coreset": (jbase.lightweight_coreset_kmeans,
                tbase.lightweight_coreset_kmeans, {"s": 800}),
    "da_mssc": (jbase.da_mssc, tbase.da_mssc, {"s": 800, "q": 4}),
}
WEIGHTED = ("coreset",)    # counts are sums of float weights


def t(a):
    return torch.from_numpy(np.array(a))


def assert_close(got, want, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * scale, err_msg=what)


def assert_result_matches(got, want, weighted: bool):
    assert got.iterations == int(want.iterations)
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(want.assignments))
    if weighted:
        assert_close(got.counts.numpy(), want.counts, "weighted counts")
    else:
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(want.counts))
    assert_close(got.centroids.numpy(), want.centroids, "centroids")
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=RTOL)


@pytest.mark.parametrize("name", list(LLOYD_BASELINES))
def test_baseline_matches_reference(name):
    jfn, tfn, kwargs = LLOYD_BASELINES[name]
    want = jfn(X, jax.random.PRNGKey(KEY), k=6, impl="ref", **kwargs)
    got = tfn(t(X), REPLAY.key(KEY), k=6, impl="ref", rng=REPLAY, **kwargs)
    assert_result_matches(got, want, name in WEIGHTED)


@pytest.mark.parametrize("name", list(LLOYD_BASELINES))
def test_baseline_beats_one_cluster(name):
    """tests/test_baselines.py's sanity bound under the port's own draws
    (the torch backend: its inverse-CDF categorical)."""
    _, tfn, kwargs = LLOYD_BASELINES[name]
    res = tfn(t(X), rnd.TORCH.key(KEY), k=6, **kwargs)
    assert tuple(res.centroids.shape) == (6, 10)
    assert np.isfinite(float(res.objective))
    Xt = t(X)
    trivial = float(full_objective(Xt, Xt.mean(0, keepdim=True)))
    assert float(full_objective(Xt, res.centroids)) < trivial


def test_multistart_forgy_init_and_bad_init():
    want = jbase.multistart_kmeans(X, jax.random.PRNGKey(3), k=6, n_init=3,
                                   init="forgy", impl="ref")
    got = tbase.multistart_kmeans(t(X), REPLAY.key(3), k=6, n_init=3,
                                  init="forgy", impl="ref", rng=REPLAY)
    assert_result_matches(got, want, False)
    with pytest.raises(ValueError):
        tbase.multistart_kmeans(t(X), REPLAY.key(3), k=6, init="random",
                                rng=REPLAY)


def test_ward_matches_reference_bitwise():
    c_want, lab_want = jbase.ward(X[:800], 6)
    c_got, lab_got = tbase.ward(X[:800], 6)
    np.testing.assert_array_equal(lab_got, lab_want)
    np.testing.assert_array_equal(c_got, c_want)
    assert len(np.unique(lab_got)) == 6
    with pytest.raises(MemoryError):
        tbase.ward(np.zeros((20001, 2)), 3)
    tbase.ward(np.random.default_rng(0).normal(size=(60, 2)), 3)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_weighted_update_ref_matches_reference(precision):
    rng = np.random.default_rng(4)
    x = X[:700]
    ids = rng.integers(0, 7, size=700).astype(np.int32)   # 6: outside k
    w = rng.uniform(0.1, 3.0, size=700).astype(np.float32)
    sums_w, counts_w = jref.update_ref(x, ids, 6, w, precision=precision)
    sums, counts = ref.update_ref(t(x), t(ids), 6, t(w), precision=precision)
    assert_close(sums.numpy(), sums_w, "sums")
    assert_close(counts.numpy(), counts_w, "counts")
    # through ops, the weighted two-pass step (reference impl='ref')
    c = X[:6]
    s_w, n_w, f_w = jops.fused_step(x, c, weights=w, impl="ref",
                                    precision=precision)
    s_g, n_g, f_g = ops.fused_step(t(x), t(c), weights=t(w), impl="ref",
                                   precision=precision)
    assert_close(s_g.numpy(), s_w, "step sums")
    assert_close(n_g.numpy(), n_w, "step counts")
    np.testing.assert_allclose(float(f_g), float(f_w), rtol=RTOL)


def test_weighted_lloyd_and_seed_match_reference():
    pts = X[:1200]
    w = np.random.default_rng(5).uniform(0.2, 5.0, size=1200).astype(
        np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        c_want = jkpp.seed(pts, key, 6, weights=w)
        c_got = kmeanspp.seed(t(pts), key, 6, weights=t(w), rng=REPLAY)
        np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_want))
    init = np.asarray(c_want)
    want = jkm.lloyd(pts, init, weights=w, impl="ref")
    got = kmeans.lloyd(t(pts), t(init), weights=t(w), impl="ref")
    assert_result_matches(got, want, True)


def test_categorical_replay_is_jax_categorical():
    logits = np.log(np.random.default_rng(1).uniform(0.01, 9, 300)
                    ).astype(np.float32)
    logits[7] = -np.inf
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.categorical(key, logits, shape=(50,)))
        got = REPLAY.categorical(key, t(logits), 50, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


def test_torch_categorical_frequencies_and_memory():
    """The inverse-CDF draw has softmax(logits)'s distribution (chi-square
    of 200,000 draws over 8 categories, one of zero mass, below 24.32: the
    0.999 quantile at 6 degrees of freedom; the draw is a pure function of
    its key) and its memory stays O(m + size): no op allocates more than
    16 bytes a row (a [size, m] noise would be 4 * size * m)."""
    p = np.array([0.3, 0.05, 0.0, 0.15, 0.2, 0.1, 0.12, 0.08])
    logits = torch.log(torch.tensor(p, dtype=torch.float32))
    n = 200_000
    idx = rnd.TORCH.categorical(rnd.TORCH.key(2), logits, n, "cpu")
    assert idx.dtype == torch.int64 and tuple(idx.shape) == (n,)
    freq = np.bincount(idx.numpy(), minlength=8)
    assert freq[2] == 0
    expect = n * p[p > 0]
    chi2 = float(np.sum((freq[p > 0] - expect) ** 2 / expect))
    assert chi2 < 24.32, chi2
    assert torch.equal(
        idx, rnd.TORCH.categorical(rnd.TORCH.key(2), logits, n, "cpu"))

    m, size = 100_000, 1_000
    big = torch.randn(m)
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        rnd.TORCH.categorical(rnd.TORCH.key(3), big, size, "cpu")
    peak = max(e.cpu_memory_usage for e in prof.key_averages())
    assert 0 < peak <= 16 * (m + size), peak


@pytest.mark.parametrize("name", ["coreset", "da_mssc", "forgy",
                                  "kmeans_parallel", "kmeanspp", "ward"])
def test_fit_method_matches_reference_facade(name):
    """tests/test_api.py:272-289 on both facades: the reference's
    ``algorithm``, ``strategy``, ``n_chunks``, ``extras`` keys, centroids
    and objective; Ward's labels equal.  Ward's host merge grows as m^2,
    so it runs on the first 2,000 rows in both packages."""
    data = X_API[:2000] if name == "ward" else X_API
    want = japi.fit(data, japi.BigMeansConfig(**CFG), method=name,
                    key=jax.random.PRNGKey(1))
    got = api.fit(data, api.BigMeansConfig(**CFG), method=name,
                  key=REPLAY.key(1), rng=REPLAY, device="cpu")
    assert isinstance(got, api.FitResult)
    assert (got.algorithm, got.strategy, got.n_chunks, got.n_accepted,
            got.n_iterations) == (want.algorithm, want.strategy,
                                  want.n_chunks, want.n_accepted,
                                  want.n_iterations)
    assert set(got.extras) == set(want.extras)
    assert got.extras["fit"]["method"] == name
    assert_close(got.centroids.numpy(), want.centroids, "centroids")
    if name == "da_mssc":
        # a weighted sum over the pool of centroids, each term the
        # cancelling x2 - 2x.c + c2 of a point at its centroid: held to
        # RTOL of the terms' magnitude (test_torch_cuda.d_bound)
        pool, w = _ref_da_mssc_pool(X_API, jax.random.PRNGKey(1), k=5,
                                    s=500, q=8)
        c = np.asarray(want.centroids, np.float64)
        ids = ((pool[:, None] - c[None]) ** 2).sum(-1).argmin(1)
        atol = RTOL * float(np.sum(w * (np.linalg.norm(pool, axis=1)
                                        + np.linalg.norm(c[ids], axis=1))
                                   ** 2))
        assert abs(got.objective - want.objective) <= atol
    else:
        np.testing.assert_allclose(got.objective, want.objective, rtol=RTOL)
    if name == "ward":
        np.testing.assert_array_equal(got.extras["labels"],
                                      want.extras["labels"])
    else:
        np.testing.assert_allclose(got.extras["counts"],
                                   want.extras["counts"], rtol=RTOL)
    assert got.extras.get("objective_scope") == want.extras.get(
        "objective_scope")
    _, f_full = api.evaluate(got, data, device="cpu")
    _, f_want = japi.evaluate(want, data)
    np.testing.assert_allclose(f_full, f_want, rtol=RTOL)


def _ref_da_mssc_pool(X, key, *, k, s, q, candidates=3):
    """The reference's DA-MSSC pool and weights (its phase 1, ``lax.map``
    taken chunk by chunk), in float64."""
    key, kperm = jax.random.split(key)
    idx = np.asarray(jax.random.randint(kperm, (q, s), 0, X.shape[0]))
    keys = jax.random.split(key, q + 1)
    pool, w = [], []
    for i in range(q):
        chunk = X[idx[i]]
        c0 = jkpp.kmeanspp(chunk, keys[i + 1], k, candidates=candidates)
        res = jkm.lloyd(chunk, c0, impl="ref")
        pool.append(np.asarray(res.centroids, np.float64))
        w.append(np.asarray(res.counts, np.float64))
    return np.concatenate(pool), np.concatenate(w)


def test_list_methods_and_unknown_method():
    assert api.list_methods() == japi.list_methods()
    assert api.list_baselines() == japi.list_baselines()
    cfg = api.BigMeansConfig(k=3, s=100, n_chunks=2)
    for method in ("multistart", "nope"):
        with pytest.raises(KeyError, match="unknown method"):
            api.fit(X[:600], cfg, method=method, device="cpu")
        with pytest.raises(KeyError):
            japi.fit(X[:600], japi.BigMeansConfig(k=3, s=100, n_chunks=2),
                     method=method)
    with pytest.raises(TypeError, match="in-core"):
        api.fit(lambda i: X[:100], cfg, method="forgy", n_features=10,
                device="cpu")
    assert api.get_baseline("forgy") is api.baselines._BASELINES["forgy"]


def test_minmax_normalize_and_streaming_minmax_match_reference():
    x = (np.random.default_rng(2).normal(size=(100, 7)) * 9.0).astype(
        np.float32)
    z = normalize.minmax_normalize(t(x))
    assert float(z.min()) >= 0.0 and float(z.max()) <= 1.0
    np.testing.assert_array_equal(z.numpy(),
                                  np.asarray(jnorm.minmax_normalize(x)))
    x = np.random.default_rng(3).normal(size=(300, 4)).astype(np.float32)
    lo, hi = normalize.streaming_minmax([t(x[:100]), t(x[100:])])
    jlo, jhi = jnorm.streaming_minmax([jnp.asarray(x[:100]),
                                       jnp.asarray(x[100:])])
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), x.min(0))


@pytest.mark.parametrize("backend", [rnd.TORCH, REPLAY],
                         ids=["torch", "jax-replay"])
def test_quality_ordering_bigmeans_vs_multistart(backend):
    """tests/test_baselines.py:53-60 on the port: Big-means within 10 % of
    multi-start K-means++ while only touching chunks."""
    Xt = t(X)
    key = backend.key(KEY)
    st, _ = big_means(Xt, key, k=6, s=800, n_chunks=25, rng=backend,
                      device="cpu")
    pp = tbase.multistart_kmeans(Xt, key, k=6, n_init=3, rng=backend)
    f_bm = float(full_objective(Xt, st.centroids))
    f_pp = float(full_objective(Xt, pp.centroids))
    assert f_bm <= f_pp * 1.10
    if backend is REPLAY:
        jst, _ = j_big_means(X, jax.random.PRNGKey(KEY), k=6, s=800,
                             n_chunks=25)
        assert_close(st.centroids.numpy(), jst.centroids, "big-means")
