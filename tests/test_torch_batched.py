"""Parity of the port's batched path (B incumbent streams on one device)
with the reference, one decision at a time.

Both packages get the same numpy inputs; the port draws through the
jax-replay backend of ``test_torch_rng``, so chunk samples and K-means++
proposals are the reference's.  Decisions (iterations per stream and per
chunk, ids, counts, accepts, ``n_accepted``, ``n_dist_evals``) must be
equal; objectives, sums and centroids differ only by summation order and
are held to ``RTOL``.

The reference's own batch=1 test (``tests/test_api.py::
test_batched_batch1_fp_identical_to_sequential``) fails on the reference by
a 2e-7 float-association difference of its batched oracle; the port is held
to the reference functions' outputs within ``RTOL``, not to that assertion,
and keeps its own stronger invariant: its batch=1 run equals its sequential
run bit for bit.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import bigmeans as jbm
from repro.core import kmeans as jkm
from repro.data.synthetic import GMMSpec, gmm_dataset
from repro.evalsuite.datasets import get_dataset
from repro.kernels import fused_step as jfused
from repro.kernels import ops as jops
from repro_torch import api, convert
from repro_torch.core import bigmeans, kmeans, kmeanspp
from repro_torch.kernels import fused_step, ops
from test_torch_cuda import blobs, sums_bound
from test_torch_rng import REPLAY

jkpp = importlib.import_module("repro.core.kmeanspp")

RTOL = 1e-5   # f32 results of the same arithmetic in another order

DATA = {n: np.asarray(gmm_dataset(GMMSpec(m=4096, n=n, components=15,
                                          seed=2)))
        for n in (3, 28)}


def t(a):
    return torch.from_numpy(np.array(a))


def streams(B, m, k, n):
    """B independent well-separated blob sets: x [B,m,n], c [B,k,n]."""
    xs, cs = zip(*(blobs(m, k, n, seed=10 * b + k) for b in range(B)))
    return np.stack(xs), np.stack(cs)


SHAPES = [  # (B, m, k, n): ragged m (tiles of 256 rows) everywhere
    (4, 300, 25, 28),    # the main path's k and n
    (3, 257, 1, 3),      # k = 1, n = 3
    (2, 513, 33, 40),    # k not a multiple of 32, n > 32
    (2, 1000, 15, 3),
]


@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"B{b}-m{m}-k{k}-n{n}" for b, m, k, n in SHAPES])
def test_fused_step_batched_matches_reference(shape):
    B, m, k, n = shape
    x, c = streams(*shape)
    assert fused_step.fits_batched(k, n) == jfused.fits_batched(k, n)
    sums, counts, obj = ops.fused_step_batched(t(x), t(c), impl="ref")
    assert sums.shape == (B, k, n) and counts.shape == (B, k)
    assert obj.shape == (B,)
    refs = {"pallas_interpret": jfused.fused_step_batched_pallas(
                x, c, interpret=True),
            "ref": jops._fused_step_batched_ref(x, c)}
    for name, (jsums, jcounts, jobj) in refs.items():
        # well-separated data: counts exact; sums and obj to RTOL
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts),
                                      err_msg=name)
        np.testing.assert_allclose(obj.numpy(), np.asarray(jobj), rtol=RTOL,
                                   err_msg=name)
        for b in range(B):
            ids = np.asarray(jops.assign(x[b], c[b], impl="ref")[0])
            err = np.abs(sums[b].numpy() - np.asarray(jsums)[b])
            assert np.all(err <= sums_bound(x[b], ids, k)), (name, b)


def test_fused_step_batched_dispatch_off_the_card():
    """'ref' and 'ref_chunked' take the plain version, which is the
    sequential plain step stream by stream; no kernel is counted."""
    x, c = streams(3, 300, 25, 28)
    X, C = t(x), t(c)
    ops.reset_launch_counts()
    plain = fused_step.fused_step_batched_plain(X, C)
    for impl in ("ref", "ref_chunked", "auto"):
        got = ops.fused_step_batched(X, C, impl=impl)
        assert all(torch.equal(a, b) for a, b in zip(got, plain)), impl
    for b in range(3):
        one = fused_step.fused_step_plain(X[b], C[b])
        assert all(torch.equal(a[b], o) for a, o in zip(plain, one))
    assert set(ops.launch_counts().values()) == {0}
    assert "fused_step_batched" in ops.launch_counts()
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.fused_step_batched(X, C, impl="cuda")


def _lloyd_inputs(n, B=3, s=1000, k=15):
    X = DATA[n]
    pts = np.stack([X[i * s:(i + 1) * s] for i in range(B)])
    init = np.stack([np.asarray(jkpp.kmeanspp(pts[i],
                                              jax.random.PRNGKey(i), k))
                     for i in range(B)])
    return pts, init


@pytest.mark.parametrize("n", [3, 28])
@pytest.mark.parametrize("max_iters,tol", [(300, 1e-4), (4, 1e-4),
                                           (3, 0.0)])
def test_lloyd_batched_matches_reference(n, max_iters, tol):
    pts, init = _lloyd_inputs(n)
    want = jkm.lloyd_batched(pts, init, max_iters=max_iters, tol=tol,
                             impl="ref")
    got = kmeans.lloyd_batched(t(pts), t(init), max_iters=max_iters,
                               tol=tol, impl="ref")
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    if max_iters == 300:     # streams that stop early while others go on
        assert len(set(got.iterations.tolist())) > 1
    for field in ("assignments", "counts", "degenerate"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    scale = float(np.abs(np.asarray(want.centroids)).max())
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(got.objective.numpy(),
                               np.asarray(want.objective), rtol=RTOL)

    # B independent port lloyd calls: the same arithmetic, bit for bit
    for b in range(pts.shape[0]):
        one = kmeans.lloyd(t(pts)[b], t(init)[b], max_iters=max_iters,
                           tol=tol, impl="ref")
        assert one.iterations == int(got.iterations[b])
        assert torch.equal(one.centroids, got.centroids[b])
        assert torch.equal(one.objective, got.objective[b])
        assert torch.equal(one.assignments, got.assignments[b])


def test_seed_batched_matches_reference_with_replay():
    """Streams with and without degenerate slots: a stream with none keeps
    its rows (the reference's vmapped seed returns ``init`` for it)."""
    B, s, k = 4, 1024, 15
    X = DATA[28]
    pts = np.stack([X[i * s:(i + 1) * s] for i in range(B)])
    init = np.stack([pts[i, :k] for i in range(B)])
    deg = np.zeros((B, k), bool)
    deg[0, [1, 6, 14]] = True            # a few slots
    deg[2] = True                        # every slot (fresh seeding)
    deg[3, 0] = True                     # one slot; stream 1 has none
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = np.asarray(jkpp.seed_batched(pts, keys, k, init=init,
                                        degenerate=deg))
    got = kmeanspp.seed_batched(t(pts), list(keys), k, init=t(init),
                                degenerate=t(deg), rng=REPLAY).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], init[1])
    np.testing.assert_array_equal(got[0][~deg[0]], init[0][~deg[0]])


def _batched_state(B=4, k=5, n=3, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(10, 20, B).astype(np.float32)
    f[2] = f[1] = f.min() - 1.0          # a tie: the first stream wins
    return (rng.normal(size=(B, k, n)).astype(np.float32),
            rng.uniform(size=(B, k)) < 0.3, f,
            rng.integers(0, 5, B).astype(np.int32),
            (rng.integers(1, 100, B) * 1024.0).astype(np.float32))


def test_state_algebra_matches_reference():
    fields = _batched_state()
    jstates = jbm.BigMeansState(*fields)
    states = convert.state_from_numpy(*fields, device="cpu")
    # the batched state round-trips through numpy, dtypes and all
    for a, b in zip(convert.state_to_numpy(states), fields):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    base = jbm.BigMeansState(*(np.asarray(f[0]) for f in fields))
    pbase = convert.state_from_numpy(*(f[0] for f in fields), device="cpu")
    for got, want in (
            (bigmeans.reduce_state(states), jbm.reduce_state(jstates)),
            (bigmeans.reduce_state(states, pbase),
             jbm.reduce_state(jstates, base)),
            (bigmeans._sync_streams(states), jbm._sync_streams(jstates)),
            (bigmeans.broadcast_state(pbase, 3),
             jbm.broadcast_state(base, 3))):
        for g, w in zip(convert.state_to_numpy(got), want):
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    red = bigmeans.reduce_state(states)
    assert torch.equal(red.centroids, states.centroids[1])      # first tie
    # broadcast then reduce: the incumbent back, counters onto the base
    back = bigmeans.reduce_state(bigmeans.broadcast_state(pbase, 3), pbase)
    for a, b in zip(back, pbase):
        assert a.dtype == b.dtype
    assert torch.equal(back.centroids, pbase.centroids)
    assert torch.equal(back.degenerate, pbase.degenerate)
    assert torch.equal(back.f_best, pbase.f_best)
    assert torch.equal(back.n_accepted, pbase.n_accepted)
    assert torch.equal(back.n_dist_evals, pbase.n_dist_evals)


@pytest.mark.parametrize("n", [3, 28])
def test_chunk_step_batched_matches_reference(n):
    """Per stream the same accept, iterations, degenerate count and n_d, with
    the port started from the reference's streams each round."""
    X, B, s, k = DATA[n], 3, 1024, 15
    jstates = jbm.broadcast_state(jbm.init_state(k, n), B)
    keys = jax.random.split(jax.random.PRNGKey(5), 4 * B).reshape(4, B, -1)
    seen_accept = seen_reject = False
    for keys_r in keys:
        split = jax.vmap(jax.random.split)(keys_r)
        ks, kc = split[:, 0], split[:, 1]
        pts = np.stack([np.asarray(jbm.sample_chunk(X, kk, s)) for kk in ks])
        states = convert.state_from_numpy(*(np.asarray(f) for f in jstates),
                                          device="cpu")
        jnew, jinfo = jbm.chunk_step_batched(pts, jstates, kc, impl="ref")
        new, info = bigmeans.chunk_step_batched(t(pts), states, list(kc),
                                                impl="ref", rng=REPLAY)
        for field in ("accepted", "lloyd_iters", "n_degenerate"):
            np.testing.assert_array_equal(getattr(info, field).numpy(),
                                          np.asarray(getattr(jinfo, field)),
                                          err_msg=field)
        np.testing.assert_allclose(info.f_new.numpy(),
                                   np.asarray(jinfo.f_new), rtol=RTOL)
        c, deg, f, acc, nd = convert.state_to_numpy(new)
        np.testing.assert_array_equal(deg, np.asarray(jnew.degenerate))
        np.testing.assert_array_equal(acc, np.asarray(jnew.n_accepted))
        np.testing.assert_array_equal(nd, np.asarray(jnew.n_dist_evals))
        np.testing.assert_allclose(f, np.asarray(jnew.f_best), rtol=RTOL)
        scale = float(np.abs(np.asarray(jnew.centroids)).max())
        np.testing.assert_allclose(c, np.asarray(jnew.centroids), rtol=RTOL,
                                   atol=RTOL * scale)
        seen_accept |= bool(np.any(np.asarray(jinfo.accepted)))
        seen_reject |= not bool(np.all(np.asarray(jinfo.accepted)))
        jstates = jbm._sync_streams(jnew)
    assert seen_accept and seen_reject


SYNCS = {"sync_every=1": dict(sync_every=1),
         "sync_every=2": dict(sync_every=2),
         "competitive": dict(sync="competitive")}


@pytest.fixture(scope="module", params=("road3d-24k", "hepmass-16k"))
def dataset(request):
    spec = get_dataset(request.param)
    return spec, np.asarray(gmm_dataset(spec.gmm))


@pytest.mark.parametrize("sync", SYNCS)
def test_fit_batched_matches_reference(dataset, sync):
    """fit(method='batched', batch=4) against the reference's
    fit(method='batched', impl='ref'): the same round-major accept sequence,
    per-chunk Lloyd iterations, n_accepted and n_dist_evals; objective and
    centroids to RTOL."""
    spec, X = dataset
    cfg = dict(k=spec.k, s=spec.s, n_chunks=spec.n_chunks, batch=4,
               **SYNCS[sync])
    want = japi.fit(X, japi.BigMeansConfig(**cfg), method="batched",
                    impl="ref")
    got = api.fit(X, api.BigMeansConfig(**cfg), method="batched",
                  device="cpu", rng=REPLAY)
    assert got.strategy == "batched"
    assert got.extras["batch"] == 4
    assert got.extras["rounds"] == want.extras["rounds"] == 6
    assert [a for *_, a in got.trace] == [a for *_, a in want.trace]
    assert got.n_accepted == want.n_accepted
    assert got.n_iterations == want.n_iterations
    assert got.n_chunks == want.n_chunks == spec.n_chunks
    assert got.n_dist_evals == want.n_dist_evals
    np.testing.assert_allclose([f for _, f, _ in got.trace],
                               [f for _, f, _ in want.trace], rtol=RTOL)
    np.testing.assert_allclose(got.objective, want.objective, rtol=RTOL)
    ref_c = np.asarray(want.centroids)
    np.testing.assert_allclose(got.centroids.numpy(), ref_c, rtol=RTOL,
                               atol=RTOL * float(np.abs(ref_c).max()))
    _, f = api.evaluate(got, X, device="cpu")
    _, jf = japi.evaluate(want, X)
    np.testing.assert_allclose(f, jf, rtol=RTOL)

    # per chunk, round-major: Lloyd iterations and degenerate counts
    rounds = cfg["n_chunks"] // 4
    every = rounds if sync == "competitive" else cfg["sync_every"]
    kw = dict(k=spec.k, s=spec.s, batch=4, rounds=rounds, sync_every=every)
    _, jinfos = jbm.big_means_batched(X, jax.random.PRNGKey(0), impl="ref",
                                      **kw)
    _, infos = bigmeans.big_means_batched(X, REPLAY.key(0), rng=REPLAY,
                                          device="cpu", **kw)
    for field in ("lloyd_iters", "accepted", "n_degenerate"):
        np.testing.assert_array_equal(getattr(infos, field).numpy(),
                                      np.asarray(getattr(jinfos, field)),
                                      err_msg=field)


@pytest.mark.parametrize("rng", [None, REPLAY], ids=["torch", "jax-replay"])
def test_batch1_fit_is_bitwise_sequential(rng):
    """The port's own invariant: batch=1 runs the sequential schedule and
    arithmetic, so every output is bitwise equal."""
    spec = get_dataset("hepmass-16k")
    X = np.asarray(gmm_dataset(spec.gmm))
    cfg = api.BigMeansConfig(k=spec.k, s=spec.s, n_chunks=12, seed=4)
    seq = api.fit(X, cfg, method="sequential", device="cpu", rng=rng)
    one = api.fit(X, cfg, method="batched", device="cpu", rng=rng)
    assert one.strategy == "batched" and one.extras["rounds"] == 12
    assert torch.equal(one.centroids, seq.centroids)
    assert one.objective == seq.objective
    assert one.trace == seq.trace
    assert one.n_accepted == seq.n_accepted
    assert one.n_iterations == seq.n_iterations
    assert one.n_dist_evals == seq.n_dist_evals


def test_batched_strategy_validates_and_auto_resolves():
    X = DATA[3]
    cfg = api.BigMeansConfig(k=4, s=256, n_chunks=8)
    with pytest.raises(ValueError, match="divide n_chunks"):
        api.fit(X, cfg, method="batched", batch=3, device="cpu")
    with pytest.raises(ValueError, match="divide the round count"):
        api.fit(X, cfg, method="batched", batch=2, sync_every=3,
                device="cpu")
    for kw in (dict(batch=3), dict(batch=2, sync_every=3)):
        with pytest.raises(ValueError):
            japi.fit(X, japi.BigMeansConfig(k=4, s=256, n_chunks=8, **kw),
                     method="batched", impl="ref")
    src = api.as_source(X)
    assert api.resolve_auto(cfg.replace(batch=4), src) == "batched"
    assert api.resolve_auto(cfg, src) == "sequential"
    res = api.fit(X, cfg, batch=4, sync_every=2, device="cpu")
    assert res.strategy == "batched" and res.extras["auto"]
    assert res.extras["batch"] == 4 and res.extras["rounds"] == 2
    assert res.n_chunks == 8 and len(res.trace) == 8
    assert res.centroids.shape == (4, 3)
    assert np.isfinite(res.objective)
    assert res.objective <= min(f for _, f, _ in res.trace)
