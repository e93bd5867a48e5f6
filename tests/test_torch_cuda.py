"""The CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda``: it decides inside the test whether a
card is present and skips with the reason where there is none.  This file
imports neither ``jax`` nor ``repro``, so it runs on a machine that has
only PyTorch (with ``--noconftest``: the suite's conftest configures JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The shared helpers (``blobs``, ``int8_exact_blobs`` and the error bounds)
are used by the CPU parity tests too.
"""
import json
import math
import sys
import threading

import numpy as np
import pytest
import torch

RTOL = 1e-5   # f32 sums in another order: ~1e-7 per term, far inside 1e-5


def blobs(m, k, n, seed=0):
    """Points around k well-separated centres (spread 5, unit noise)."""
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(k, n)) * 5.0).astype(np.float32)
    comp = rng.integers(0, k, size=m)
    x = (c[comp] + rng.normal(size=(m, n))).astype(np.float32)
    return x, c


def int8_exact_blobs(m=300, n=24, k=25, seed=0):
    """Integer data on which int8 quantization is exact: a copy of the
    reference's ``tests/test_precision.py:_int8_exact_blobs``.

    One point row of +/-127 pins every per-feature scale to 1, a 127
    column in the centroids pins every per-row scale to 1; codes then
    reproduce the values and every sum stays an integer below 2**24, so
    int8 results compare bitwise whatever the tiling or the order.
    """
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, size=(m, n)).astype(np.float32)
    x[0, :] = 127.0
    x[1, :] = -127.0
    c = rng.integers(-8, 9, size=(k, n)).astype(np.float32)
    c[:, 0] = 127.0
    return x, c


def d_bound(x, c, ids):
    """|error| of x2 - 2x.c + c2 in f32: RTOL of the terms' magnitude."""
    x2 = np.sum(x.astype(np.float64) ** 2, axis=1)
    c2 = np.sum(c.astype(np.float64) ** 2, axis=1)[ids]
    return RTOL * (np.sqrt(x2) + np.sqrt(c2)) ** 2


def sums_bound(x, ids, k):
    """|error| of a cluster's f32 sum: RTOL of the sum of |x| in it."""
    abs_sums = np.zeros((k, x.shape[1]))
    ok = (ids >= 0) & (ids < k)
    np.add.at(abs_sums, ids[ok], np.abs(x[ok]).astype(np.float64))
    return RTOL * abs_sums + 1e-6


TM = 256      # rows per point tile (csrc/common.cuh:TM)


def split_bf16(x):
    """(hi, lo) = (bf16(x), bf16(x - hi)) as float32 arrays."""
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    hi = xt.bfloat16().float()
    return hi.numpy(), (xt - hi).bfloat16().float().numpy()


def parent_order_update(x, ids, k, G, split=False):
    """The sums and counts of the one-hot update kernels that kernels C,
    C16, C3 and C8 were before their sorted-scatter redesign, in their
    association: each 256-row tile's sums in row order from +0 (rows with
    an id in [0, k) only; under ``split`` the bf16 hi and lo parts summed
    apart and added at the tile's end), CTA g's partial P_g the tiles g,
    g + G, g + 2G, ... in order (+0 for a CTA with no tile), and the
    result ((+0 + P_0) + P_1) + ... .  Every tile's [k, n] sums take part,
    zeros for absent clusters, as in those kernels.  ``x``: float32 values
    as stored (bf16 widened), or integer codes (exact int64 sums)."""
    m, n = x.shape
    T = -(-m // TM)
    dt = np.int64 if x.dtype.kind in "iu" else np.float32
    ok = (ids >= 0) & (ids < k)
    tsum, tcnt = None, np.zeros((T, k), np.float32)
    for part in (split_bf16(x) if split else (x,)):
        acc = np.zeros((T, k, n), dt)
        cnt = np.zeros((T, k), np.float32)
        for i in range(TM):                     # row i of every tile
            r = np.arange(i, m, TM)
            r = r[ok[r]]
            acc[r // TM, ids[r]] += part[r].astype(dt)
            cnt[r // TM, ids[r]] += np.float32(1)
        tsum, tcnt = (acc, cnt) if tsum is None else (tsum + acc, cnt)
    sums, counts = np.zeros((k, n), dt), np.zeros(k, np.float32)
    for g in range(G):
        tiles = range(g, T, G)
        P = np.zeros((k, n), dt) if not tiles else tsum[g].copy()
        C = np.zeros(k, np.float32) if not tiles else tcnt[g].copy()
        for t in tiles[1:]:
            P, C = P + tsum[t], C + tcnt[t]
        sums, counts = sums + P, counts + C
    return sums, counts


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90): the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _near_ties(x, c):
    scores = (c * c).sum(1)[None, :] - 2.0 * (x @ c.T)
    two = torch.topk(scores, 2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) <= 1e-4 * two[:, 0].abs()


def near_ties_int8(qx, c):
    """Rows whose best two int8 scores csq - 2 float(xq.cq) t are within
    1e-4 relative (the kernels' argmin; the oracle's adds ||x||^2)."""
    from repro_torch.kernels import precision as px

    cq, t = px.quantize_centroids(c, qx.scale)
    dots = px.intdot(qx.q, cq, ([1], [1])).float() * t[None, :]
    scores = px.sqnorm_in_order(c)[None, :] - 2.0 * dots
    if scores.shape[1] < 2:
        return torch.zeros(scores.shape[0], dtype=torch.bool,
                           device=scores.device)
    two = torch.topk(scores, 2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) <= 1e-4 * two[:, 0].abs()


CARD_SHAPES = [(64_000, 25, 28), (64_001, 25, 3), (64_001, 130, 68),
               (3_001, 1024, 1024), (2_001, 1024, 1100)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=[f"m{m}-k{k}-n{n}" for m, k, n in CARD_SHAPES])
def test_kernels_match_plain_on_card(shape):
    _card()
    from repro_torch.kernels import distance, fused_step, ops, update

    m, k, n = shape
    xn, cn = blobs(*shape, seed=6)
    x, c = torch.from_numpy(xn).cuda(), torch.from_numpy(cn).cuda()
    ties = _near_ties(x, c)
    n_ties = int(ties.sum())

    ids, d = distance.assign_f32(x, c)
    ids2, d2 = distance.assign_f32(x, c)
    assert torch.equal(ids, ids2) and torch.equal(d, d2)   # bitwise repeat
    pids, pd = distance.assign_plain(x, c)
    assert torch.equal(ids[~ties], pids[~ties])
    pidn = pids.cpu().numpy()
    assert np.all((d - pd).abs().cpu().numpy()
                  <= d_bound(xn, cn, pidn) + 1e-6)

    uids = pids.clone()
    uids[::7] = -1                 # padding: never hits
    uids[3::11] = k                # out of range: adds nothing
    sums, counts = update.update_f32(x, uids, k)
    sums2, counts2 = update.update_f32(x, uids, k)
    assert torch.equal(sums, sums2) and torch.equal(counts, counts2)
    psums, pcounts = update.update_plain(x, uids, k)
    assert torch.equal(counts, pcounts)
    assert np.all((sums - psums).abs().cpu().numpy()
                  <= sums_bound(xn, uids.cpu().numpy(), k))

    fs = ops.fused_step(x, c, impl="cuda")        # kernel A or B + C
    fs2 = ops.fused_step(x, c, impl="cuda")
    assert all(torch.equal(a, b) for a, b in zip(fs, fs2))
    psums, pcounts, pobj = fused_step.fused_step_plain(x, c)
    assert int((fs[1] - pcounts).abs().sum()) <= 2 * n_ties
    assert np.all((fs[0] - psums).abs().cpu().numpy()
                  <= sums_bound(xn, pidn, k)
                  + 2 * n_ties * float(np.abs(xn).max()))
    np.testing.assert_allclose(float(fs[2]), float(pobj), rtol=RTOL)


@pytest.mark.cuda
def test_fit_on_card_goes_through_the_kernels():
    _card()
    from repro_torch import api
    from repro_torch.core.objective import EVAL_BATCH
    from repro_torch.data.synthetic import GMMSpec, gmm_dataset
    from repro_torch.kernels import ops

    X = gmm_dataset(GMMSpec(m=300_000, n=28, components=25, seed=1))
    cfg = api.BigMeansConfig(k=25, s=8192, n_chunks=8)
    ops.reset_launch_counts()
    res = api.fit(X, cfg)
    _, f = api.evaluate(res, X)
    counts = ops.launch_counts()
    assert res.centroids.is_cuda and res.extras["fit"]["impl"] == "cuda"
    assert counts["fused_step"] == res.n_iterations
    assert counts["update"] == cfg.n_chunks
    assert counts["assign"] == cfg.n_chunks + math.ceil(X.shape[0]
                                                        / EVAL_BATCH)
    ref = api.fit(X, cfg.replace(impl="ref"))
    assert ops.launch_counts() == counts          # the plain path: no kernel
    _, f_ref = api.evaluate(ref, X)
    assert abs(f - f_ref) <= 1e-3 * f_ref


# the card shapes, and the two-pass route's (s = 16,384, k = 2,048, n = 1,024)
UPDATE_CARD_SHAPES = CARD_SHAPES + [(16_384, 2048, 1024)]


def _update_on_card(x, ids, k, precision):
    """Kernel C at ``precision`` (C8 under int8: its int32 sums) on the
    card: (sums, counts) as numpy."""
    from repro_torch.kernels import update
    from repro_torch.kernels import precision as px

    if precision == "int8":
        q, _ = px.quantize_chunk(x)
        out = update.launch_update_int8(q, ids, k)
    elif precision == "f32":
        out = update.update_f32(x, ids, k)
    else:
        out = update.update_16(x, ids, k, precision)
    return tuple(t.cpu().numpy() for t in out)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x3", "int8"])
@pytest.mark.parametrize("shape", UPDATE_CARD_SHAPES, ids=[
    f"m{m}-k{k}-n{n}" for m, k, n in UPDATE_CARD_SHAPES])
def test_update_kernels_bitwise_parent_order_on_card(shape, precision):
    """Kernels C, C16, C3 and C8 (the sorted scatter) bitwise the one-hot
    kernels they replaced: ``parent_order_update`` with G the order the
    wrapper passes (``update.order``, those kernels' grid), on ids with
    padding and out-of-range ids and a cluster of -0.0 rows; two launches
    bitwise equal."""
    _card()
    from repro_torch.kernels import distance, update
    from repro_torch.kernels import precision as px

    m, k, n = shape
    xn, cn = blobs(m, k, n, seed=8)
    x, c = torch.from_numpy(xn).cuda(), torch.from_numpy(cn).cuda()
    ids, _ = distance.assign_plain(x, c)
    ids[::7] = -1                  # padding: never hits
    ids[3::11] = k                 # out of range: adds nothing
    x[ids == 1] = -0.0             # a cluster of -0.0 rows only
    got = _update_on_card(x, ids, k, precision)
    again = _update_on_card(x, ids, k, precision)
    assert all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
               for a, b in zip(got, again))
    if precision == "int8":
        vals = px.quantize_chunk(x).q.cpu().numpy()
    else:
        vals = px.cast_storage(x, precision).float().cpu().numpy()
    sums, counts = parent_order_update(
        vals, ids.cpu().numpy(), k, update.order(x.device, m, k, n),
        split=precision == "bf16x3")
    want = sums.astype(np.int32 if precision == "int8" else np.float32)
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  counts.view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x3", "int8"])
def test_update_kernel_bitwise_fused_kernel_on_its_ids_on_card(precision):
    """At the main shape, where the update's order G equals kernel A's
    grid, kernel C (C16, C3, C8) on kernel B's ids (A's argmin code) gives
    bitwise kernel A's (A16, A3, A8) sums and counts."""
    _card()
    from repro_torch.kernels import build, ops

    m, k, n = 64_000, 25, 28
    xn, cn = blobs(m, k, n, seed=9)
    x, c = torch.from_numpy(xn).cuda(), torch.from_numpy(cn).cuda()
    assert build.grid(x.device, m, k * n + k) == build.grid(
        x.device, m, k * n + k + 1)
    sums, counts, _ = ops.fused_step(x, c, impl="cuda", precision=precision)
    ids, _ = ops.assign(x, c, impl="cuda", precision=precision)
    usums, ucounts = ops.update(x, ids, k, impl="cuda", precision=precision)
    assert torch.equal(usums.view(torch.int32), sums.view(torch.int32))
    assert torch.equal(ucounts.view(torch.int32), counts.view(torch.int32))


BATCHED_CARD_SHAPES = [(8, 64_000, 25, 28), (3, 64_001, 25, 3),
                       (2, 64_001, 130, 68), (2, 3_001, 1024, 1024),
                       (2, 2_001, 1024, 1100)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BATCHED_CARD_SHAPES, ids=[
    f"B{b}-m{m}-k{k}-n{n}" for b, m, k, n in BATCHED_CARD_SHAPES])
def test_batched_kernel_matches_plain_and_kernel_a_on_card(shape):
    """Kernel D (through ops: outside the envelope the two-pass route) on
    the card: stream b bitwise equal to kernel A on stream b, two launches
    bitwise equal, and the plain version within the near-tie allowance."""
    _card()
    from repro_torch.kernels import fused_step, ops

    B, m, k, n = shape
    pairs = [blobs(m, k, n, seed=7 + b) for b in range(B)]
    x = torch.from_numpy(np.stack([p[0] for p in pairs])).cuda()
    c = torch.from_numpy(np.stack([p[1] for p in pairs])).cuda()
    ops.reset_launch_counts()
    got = ops.fused_step_batched(x, c, impl="cuda")
    again = ops.fused_step_batched(x, c, impl="cuda")
    counts = ops.launch_counts()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    fits = fused_step.fits_batched(k, n)
    assert (counts["fused_step_batched"] > 0) == fits
    assert counts["fused_step"] == 0
    plain = fused_step.fused_step_batched_plain(x, c)
    for b in range(B):
        one = ops.fused_step(x[b], c[b], impl="cuda")     # A, or B + C
        assert all(torch.equal(g[b], o) for g, o in zip(got, one)), b
        n_ties = int(_near_ties(x[b], c[b]).sum())
        assert int((got[1][b] - plain[1][b]).abs().sum()) <= 2 * n_ties
        pids = ops.assign(x[b], c[b], impl="ref")[0].cpu().numpy()
        assert np.all((got[0][b] - plain[0][b]).abs().cpu().numpy()
                      <= sums_bound(pairs[b][0], pids, k)
                      + 2 * n_ties * float(np.abs(pairs[b][0]).max()))
        np.testing.assert_allclose(float(got[2][b]), float(plain[2][b]),
                                   rtol=RTOL)


@pytest.mark.cuda
def test_batched_fit_on_card_goes_through_kernel_d():
    _card()
    from repro_torch import api
    from repro_torch.data.synthetic import GMMSpec, gmm_dataset
    from repro_torch.kernels import ops

    X = gmm_dataset(GMMSpec(m=300_000, n=28, components=25, seed=1))
    cfg = api.BigMeansConfig(k=25, s=8192, n_chunks=8, batch=4, sync_every=2)
    ops.reset_launch_counts()
    res = api.fit(X, cfg)
    counts = ops.launch_counts()
    assert res.strategy == "batched" and res.centroids.is_cuda
    assert counts["fused_step"] == 0 and counts["fused_step_batched"] > 0
    assert counts["update"] == cfg.n_chunks
    assert counts["assign"] == cfg.n_chunks
    ref = api.fit(X, cfg.replace(impl="ref"))
    assert ops.launch_counts() == counts          # the plain path: no kernel
    _, f = api.evaluate(res, X)
    _, f_ref = api.evaluate(ref, X)
    assert abs(f - f_ref) <= 1e-3 * f_ref
    # batch=1 is the sequential fit, bit for bit
    one = api.fit(X, cfg.replace(batch=1, n_chunks=4), method="batched")
    seq = api.fit(X, cfg.replace(batch=1, n_chunks=4), method="sequential")
    assert torch.equal(one.centroids, seq.centroids)
    assert one.objective == seq.objective and one.trace == seq.trace


@pytest.mark.cuda
def test_sharded_and_stream_mesh_fits_on_card():
    """The sharded strategy with 4 workers dealt onto the card goes
    through A, B and C (A once per Lloyd iteration of every worker's chunk)
    and its plain twin's full-data objective within 1e-3; the (2, 2) mesh
    over ("data", "model") has the same 4 workers, bitwise; the batched
    fit on a 2-group stream mesh is bitwise the one-device fit."""
    _card()
    from repro_torch import api
    from repro_torch.data.synthetic import GMMSpec, gmm_dataset
    from repro_torch.kernels import ops

    X = gmm_dataset(GMMSpec(m=300_000, n=28, components=25, seed=1))
    cfg = api.BigMeansConfig(k=25, s=8192, n_chunks=8, sync_every=2)
    spec = api.TopologySpec(kind="worker_mesh", devices=4)
    ops.reset_launch_counts()
    res = api.fit(X, cfg.replace(topology=spec), method="sharded")
    counts = ops.launch_counts()
    assert res.extras["workers"] == 4 and res.centroids.is_cuda
    assert counts["fused_step"] == res.n_iterations
    assert counts["update"] == counts["assign"] == cfg.n_chunks
    ref = api.fit(X, cfg.replace(topology=spec, impl="ref"),
                  method="sharded")
    _, f = api.evaluate(res, X)
    _, f_ref = api.evaluate(ref, X)
    assert abs(f - f_ref) <= 1e-3 * f_ref
    two = api.fit(X, cfg.replace(topology=api.TopologySpec(
        kind="worker_mesh", devices=(2, 2), axes=("data", "model"))),
        method="sharded")
    assert torch.equal(two.centroids, res.centroids)
    assert two.trace == res.trace
    bcfg = cfg.replace(batch=4)
    one = api.fit(X, bcfg)
    mesh = api.fit(X, bcfg.replace(topology=api.TopologySpec(
        kind="stream_mesh", devices=2)))
    assert torch.equal(one.centroids, mesh.centroids)
    assert one.objective == mesh.objective


@pytest.mark.cuda
def test_kernel_library_is_cached_by_source_digest():
    _card()
    from repro_torch.kernels import build

    build.load()
    again = build.build()
    assert not again.built and again.path == build.info().path
    assert build.source_digest() in again.path.name


# --------------------------------------------------------------------------
# int8 kernels A8, B8, C8, D8
# --------------------------------------------------------------------------

INT8_CARD_SHAPES = [(64_000, 25, 28), (64_001, 25, 3), (64_001, 129, 68),
                    (3_001, 1024, 1024), (2_001, 1024, 1100)]


@pytest.mark.cuda
@pytest.mark.parametrize("data", ["blobs", "exact"])
@pytest.mark.parametrize("shape", INT8_CARD_SHAPES, ids=[
    f"m{m}-k{k}-n{n}" for m, k, n in INT8_CARD_SHAPES])
def test_int8_kernels_match_plain_on_card(shape, data):
    """Kernels B8, C8 and A8 (outside the envelope: B8 + C8) on the card
    against the plain int8 versions: two launches bitwise equal; int32
    sums bitwise given the same ids (C8) and counts exact; ids equal off
    near ties and d within the f32 norm bound; on the exact blobs ids,
    sums, counts and d bitwise (the kernel and the plain version both add
    ||x||^2 and ||c||^2 feature by feature, so d matches past 2**24 too,
    where the order decides the rounding).  The objective, a sum of m
    integers, passes 2**24 at these m: it is held to ``RTOL``."""
    _card()
    from repro_torch.kernels import distance, fused_step, ops, update
    from repro_torch.kernels import precision as px

    m, k, n = shape
    if data == "blobs":
        xn, cn = blobs(m, k, n, seed=6)
    else:
        xn, cn = int8_exact_blobs(m, n, k, seed=6)
    x, c = torch.from_numpy(xn).cuda(), torch.from_numpy(cn).cuda()
    qx = px.quantize_chunk(x)
    ties = near_ties_int8(qx, c)
    n_ties = int(ties.sum())
    exact = data == "exact"

    ids, d = distance.assign_int8(qx, c)
    ids2, d2 = distance.assign_int8(qx, c)
    assert torch.equal(ids, ids2) and torch.equal(d, d2)   # bitwise repeat
    pids, pd = distance.assign_int8_plain(qx, c)
    assert torch.equal(ids[~ties], pids[~ties])
    if exact:
        assert torch.equal(ids, pids)
        assert torch.equal(d, pd)
    deq = px.dequantize(qx).cpu().numpy()
    assert np.all((d - pd).abs().cpu().numpy()
                  <= d_bound(deq, cn, pids.cpu().numpy()) + 1e-6)

    uids = pids.clone()
    uids[::7] = -1                 # padding: never hits
    uids[3::11] = k                # out of range: adds nothing
    sums, counts = update.update_int8(qx, uids, k)
    sums2, counts2 = update.update_int8(qx, uids, k)
    assert torch.equal(sums, sums2) and torch.equal(counts, counts2)
    psums, pcounts = update.update_int8_plain(qx, uids, k)
    assert torch.equal(counts, pcounts) and torch.equal(sums, psums)

    fs = ops.fused_step(qx, c, impl="cuda")       # kernel A8 or B8 + C8
    fs2 = ops.fused_step(qx, c, impl="cuda")
    assert all(torch.equal(a, b) for a, b in zip(fs, fs2))
    psums, pcounts, pobj = fused_step.fused_step_int8_plain(qx, c)
    if exact or n_ties == 0:
        assert torch.equal(fs[0], psums) and torch.equal(fs[1], pcounts)
    assert int((fs[1] - pcounts).abs().sum()) <= 2 * n_ties
    tie_room = 2 * n_ties * 127 * float(qx.scale.max())
    assert float((fs[0] - psums).abs().max()) <= tie_room
    np.testing.assert_allclose(float(fs[2]), float(pobj), rtol=RTOL)


INT8_BATCHED_CARD_SHAPES = [(8, 64_000, 25, 28), (3, 64_001, 25, 3),
                            (2, 3_001, 1024, 1024), (2, 2_001, 1024, 1100)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", INT8_BATCHED_CARD_SHAPES, ids=[
    f"B{b}-m{m}-k{k}-n{n}" for b, m, k, n in INT8_BATCHED_CARD_SHAPES])
def test_int8_batched_kernel_matches_kernel_a8_on_card(shape):
    """Kernel D8 (through ops: outside the envelope B8 + C8 per stream):
    stream b bitwise equal to the single-stream route on stream b, two
    calls bitwise equal, and the plain version within the near-tie
    allowance."""
    _card()
    from repro_torch.kernels import fused_step, ops
    from repro_torch.kernels import precision as px

    B, m, k, n = shape
    pairs = [blobs(m, k, n, seed=7 + b) for b in range(B)]
    x = torch.from_numpy(np.stack([p[0] for p in pairs])).cuda()
    c = torch.from_numpy(np.stack([p[1] for p in pairs])).cuda()
    qx = px.quantize_chunk(x)                 # one scale row per stream
    ops.reset_launch_counts()
    got = ops.fused_step_batched(qx, c, impl="cuda")
    again = ops.fused_step_batched(qx, c, impl="cuda")
    counts = ops.launch_counts()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    fits = fused_step.fits_batched(k, n)
    assert (counts["fused_step_batched_int8"] > 0) == fits
    assert counts["fused_step_int8"] == 0 and counts["fused_step_batched"] == 0
    plain = fused_step.fused_step_batched_int8_plain(qx, c)
    for b in range(B):
        qb = px.QuantizedChunk(qx.q[b], qx.scale[b])
        one = ops.fused_step(qb, c[b], impl="cuda")        # A8, or B8 + C8
        assert all(torch.equal(g[b], o) for g, o in zip(got, one)), b
        n_ties = int(near_ties_int8(qb, c[b]).sum())
        assert int((got[1][b] - plain[1][b]).abs().sum()) <= 2 * n_ties
        tie_room = 2 * n_ties * 127 * float(qb.scale.max())
        assert float((got[0][b] - plain[0][b]).abs().max()) <= tie_room
        np.testing.assert_allclose(float(got[2][b]), float(plain[2][b]),
                                   rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4], ids=["sequential", "batched"])
def test_int8_fit_on_card_goes_through_the_int8_kernels(batch):
    """fit(precision="int8"): A8 (D8 when batched) in the Lloyd loop, f32
    kernels B and C in the epilogue, B8 and C8 never (inside the
    envelope); the plain path reaches the same full-data objective within
    1e-3."""
    _card()
    from repro_torch import api
    from repro_torch.data.synthetic import GMMSpec, gmm_dataset
    from repro_torch.kernels import ops

    X = gmm_dataset(GMMSpec(m=300_000, n=28, components=25, seed=1))
    cfg = api.BigMeansConfig(k=25, s=8192, n_chunks=8, batch=batch,
                             sync_every=2 if batch > 1 else 1,
                             precision="int8")
    ops.reset_launch_counts()
    res = api.fit(X, cfg)
    counts = ops.launch_counts()
    assert res.extras["fit"]["precision"] == "int8"
    fused = "fused_step_batched_int8" if batch > 1 else "fused_step_int8"
    assert counts[fused] > 0
    if batch == 1:
        assert counts[fused] == res.n_iterations
    assert counts["assign_int8"] == counts["update_int8"] == 0
    assert counts["fused_step"] == counts["fused_step_batched"] == 0
    assert counts["update"] == counts["assign"] == cfg.n_chunks
    ref = api.fit(X, cfg.replace(impl="ref"))
    assert ops.launch_counts() == counts          # the plain path: no kernel
    _, f = api.evaluate(res, X)
    _, f_ref = api.evaluate(ref, X)
    assert abs(f - f_ref) <= 1e-3 * f_ref


# --------------------------------------------------------------------------
# bf16 and bf16x3 kernels A16, B16, C16, D16 and A3, B3, C3, D3
# --------------------------------------------------------------------------

BF16_CARD_SHAPES = [(64_000, 25, 28), (64_001, 25, 3), (64_001, 129, 68),
                    (3_001, 1024, 1024), (2_001, 1024, 1100)]


def near_ties_16(x, c, precision):
    """Rows whose best two scores ||c||^2 - 2 dot(x, c) at the policy (x
    in its storage) are within 1e-4 relative."""
    from repro_torch.kernels import precision as px

    xs = px.cast_storage(x, precision)
    scores = px.sqnorm(c)[None, :] - 2.0 * px.dot(xs, c, ([1], [1]),
                                                   precision)
    two = torch.topk(scores, 2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) <= 1e-4 * two[:, 0].abs()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("shape", BF16_CARD_SHAPES, ids=[
    f"m{m}-k{k}-n{n}" for m, k, n in BF16_CARD_SHAPES])
def test_bf16_kernels_match_plain_on_card(shape, precision):
    """Kernels B16/B3, C16/C3 and A16/A3 (outside the envelope: B + C at
    the policy) on the card against the plain versions at the policy (x
    cast to its storage first, as the wrappers cast it): two launches
    bitwise equal; ids equal off near ties and d within the f32 norm
    bound; counts exact on the same ids and sums within RTOL of the sum of
    |x|; the objective within RTOL.  bf16 products are exact in f32, so
    only the order of the sums differs."""
    _card()
    from repro_torch.kernels import distance, fused_step, ops, update
    from repro_torch.kernels import precision as px

    m, k, n = shape
    xn, cn = blobs(m, k, n, seed=6)
    x, c = torch.from_numpy(xn).cuda(), torch.from_numpy(cn).cuda()
    ties = near_ties_16(x, c, precision)
    n_ties = int(ties.sum())
    xs = px.cast_storage(x, precision).float().cpu().numpy()

    ids, d = distance.assign_16(x, c, precision)
    ids2, d2 = distance.assign_16(x, c, precision)
    assert torch.equal(ids, ids2) and torch.equal(d, d2)   # bitwise repeat
    pids, pd = distance.assign_plain(x, c, precision)
    assert torch.equal(ids[~ties], pids[~ties])
    pidn = pids.cpu().numpy()
    assert np.all((d - pd).abs().cpu().numpy()
                  <= d_bound(xs, cn, pidn) + 1e-6)

    uids = pids.clone()
    uids[::7] = -1                 # padding: never hits
    uids[3::11] = k                # out of range: adds nothing
    sums, counts = update.update_16(x, uids, k, precision)
    sums2, counts2 = update.update_16(x, uids, k, precision)
    assert torch.equal(sums, sums2) and torch.equal(counts, counts2)
    psums, pcounts = update.update_plain(x, uids, k, precision)
    assert torch.equal(counts, pcounts)
    assert np.all((sums - psums).abs().cpu().numpy()
                  <= sums_bound(xs, uids.cpu().numpy(), k))

    fs = ops.fused_step(x, c, impl="cuda", precision=precision)
    fs2 = ops.fused_step(x, c, impl="cuda", precision=precision)
    assert all(torch.equal(a, b) for a, b in zip(fs, fs2))
    psums, pcounts, pobj = fused_step.fused_step_plain(x, c, precision)
    assert int((fs[1] - pcounts).abs().sum()) <= 2 * n_ties
    assert np.all((fs[0] - psums).abs().cpu().numpy()
                  <= sums_bound(xs, pidn, k)
                  + 2 * n_ties * float(np.abs(xs).max()))
    np.testing.assert_allclose(float(fs[2]), float(pobj), rtol=RTOL)


BF16_BATCHED_CARD_SHAPES = [(8, 64_000, 25, 28), (3, 64_001, 25, 3),
                            (2, 3_001, 1024, 1024), (2, 2_001, 1024, 1100)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("shape", BF16_BATCHED_CARD_SHAPES, ids=[
    f"B{b}-m{m}-k{k}-n{n}" for b, m, k, n in BF16_BATCHED_CARD_SHAPES])
def test_bf16_batched_kernel_matches_single_on_card(shape, precision):
    """Kernel D16 / D3 (through ops: outside the envelope B + C at the
    policy per stream): stream b bitwise equal to the single-stream route
    on stream b, two calls bitwise equal, and the plain version within the
    near-tie allowance."""
    _card()
    from repro_torch.kernels import fused_step, ops
    from repro_torch.kernels import precision as px

    B, m, k, n = shape
    pairs = [blobs(m, k, n, seed=7 + b) for b in range(B)]
    x = torch.from_numpy(np.stack([p[0] for p in pairs])).cuda()
    c = torch.from_numpy(np.stack([p[1] for p in pairs])).cuda()
    ops.reset_launch_counts()
    got = ops.fused_step_batched(x, c, impl="cuda", precision=precision)
    again = ops.fused_step_batched(x, c, impl="cuda", precision=precision)
    counts = ops.launch_counts()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    fits = fused_step.fits_batched(k, n)
    assert (counts[f"fused_step_batched_{precision}"] > 0) == fits
    assert counts[f"fused_step_{precision}"] == 0
    plain = fused_step.fused_step_batched_plain(x, c, precision)
    for b in range(B):
        one = ops.fused_step(x[b], c[b], impl="cuda", precision=precision)
        assert all(torch.equal(g[b], o) for g, o in zip(got, one)), b
        n_ties = int(near_ties_16(x[b], c[b], precision).sum())
        assert int((got[1][b] - plain[1][b]).abs().sum()) <= 2 * n_ties
        xs = px.cast_storage(x[b], precision).float().cpu().numpy()
        pids = ops.assign(px.cast_storage(x[b], precision), c[b],
                          impl="ref", precision=precision)[0].cpu().numpy()
        assert np.all((got[0][b] - plain[0][b]).abs().cpu().numpy()
                      <= sums_bound(xs, pids, k)
                      + 2 * n_ties * float(np.abs(xs).max()))
        np.testing.assert_allclose(float(got[2][b]), float(plain[2][b]),
                                   rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("batch", [1, 4], ids=["sequential", "batched"])
def test_bf16_fit_on_card_goes_through_the_policy_kernels(batch, precision):
    """fit(precision="bf16" | "bf16x3"): A16 / A3 (D16 / D3 when batched)
    in the Lloyd loop; in the epilogue f32 B and C16 under bf16, B3 and C3
    under bf16x3; the plain path reaches the same full-data objective
    within 1e-3, and bf16 stays within 1 % of the f32 fit's."""
    _card()
    from repro_torch import api
    from repro_torch.data.synthetic import GMMSpec, gmm_dataset
    from repro_torch.kernels import ops

    X = gmm_dataset(GMMSpec(m=300_000, n=28, components=25, seed=1))
    cfg = api.BigMeansConfig(k=25, s=8192, n_chunks=8, batch=batch,
                             sync_every=2 if batch > 1 else 1,
                             precision=precision)
    ops.reset_launch_counts()
    res = api.fit(X, cfg)
    counts = ops.launch_counts()
    assert res.extras["fit"]["precision"] == precision
    fused = (f"fused_step_batched_{precision}" if batch > 1
             else f"fused_step_{precision}")
    assert counts[fused] > 0
    if batch == 1:
        assert counts[fused] == res.n_iterations
    assert counts[f"update_{precision}"] == cfg.n_chunks
    epilogue_assign = "assign" if precision == "bf16" else "assign_bf16x3"
    assert counts[epilogue_assign] == cfg.n_chunks
    assert counts["fused_step"] == counts["fused_step_batched"] == 0
    ref = api.fit(X, cfg.replace(impl="ref"))
    assert ops.launch_counts() == counts          # the plain path: no kernel
    _, f = api.evaluate(res, X)
    _, f_ref = api.evaluate(ref, X)
    assert abs(f - f_ref) <= 1e-3 * f_ref
    _, f32 = api.evaluate(api.fit(X, cfg.replace(precision="f32")), X)
    assert abs(f - f32) <= 1e-2 * f32


# --------------------------------------------------------------------------
# the dma pipeline (A-dma, A8-dma, A16-dma, A3-dma), kernel P, the tuner
# --------------------------------------------------------------------------

DMA_CARD_SHAPES = [(64_000, 25, 28), (64_001, 25, 3), (64_001, 129, 68),
                   (3_001, 1024, 1024), (20_001, 40, 37)]


def _fused_entry(precision):
    from repro_torch.kernels import fused_step

    if precision == "f32":
        return fused_step.fused_step_f32
    if precision == "int8":
        return fused_step.fused_step_int8
    return lambda x, c, pipeline: fused_step.fused_step_16(x, c, precision,
                                                           pipeline)


@pytest.mark.cuda
@pytest.mark.parametrize("data", ["blobs", "exact"])
@pytest.mark.parametrize("precision", ["f32", "int8", "bf16", "bf16x3"])
@pytest.mark.parametrize("shape", DMA_CARD_SHAPES, ids=[
    f"m{m}-k{k}-n{n}" for m, k, n in DMA_CARD_SHAPES])
def test_dma_kernels_bitwise_blocks_on_card(shape, precision, data):
    """Each dma kernel is bitwise its blocks twin (same CTA body, grid and
    reduction order), two launches bitwise equal, on Gaussian blobs and on
    integer data; its launches are counted apart from the twin's."""
    _card()
    from repro_torch.kernels import ops
    from repro_torch.kernels import precision as px

    m, k, n = shape
    xn, cn = (blobs(m, k, n, seed=11) if data == "blobs"
              else int8_exact_blobs(m, n, k, seed=11))
    x, c = torch.from_numpy(xn).cuda(), torch.from_numpy(cn).cuda()
    xs = px.cast_storage(x, precision)
    fn = _fused_entry(precision)
    blocks = fn(xs, c, "blocks")
    ops.reset_launch_counts()
    dma = fn(xs, c, "dma")
    again = fn(xs, c, "dma")
    counts = ops.launch_counts()
    suffix = "" if precision == "f32" else f"_{precision}"
    assert counts["fused_step_dma" + suffix] == 2
    assert counts["fused_step" + suffix] == 0
    for a, b, d in zip(blocks, dma, again):
        assert torch.equal(a, b) and torch.equal(b, d)


KPP_CARD_SHAPES = [  # (m, n, L, base offset in elements)
    (100, 7, 3, 0), (513, 28, 3, 0), (300, 768, 8, 0), (1000, 68, 128, 0),
    (64_000, 28, 3, 0),
    # L around every candidate tile (4, 8, 32), x and d one element off
    # their buffers, the two-pass width
    (3000, 28, 1, 0), (3000, 28, 4, 0), (3000, 28, 5, 0), (3000, 28, 8, 0),
    (3000, 28, 9, 0), (3000, 28, 33, 0), (3000, 28, 128, 0),
    (64_000, 28, 3, 1), (3000, 70, 5, 1), (16_384, 1024, 3, 0)]


def kpp_card_inputs(m, n, L, off=0):
    """x, cands standard normal, d uniform in [0, 4n) (about half the rows
    take a candidate's distance), on the card; x and d ``off`` elements
    into their buffers."""
    rng = np.random.default_rng(m + n + L)

    def placed(a):
        buf = torch.empty(a.size + off, dtype=torch.float32, device="cuda")
        view = buf[off:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        return view

    x = placed(rng.normal(size=(m, n)).astype(np.float32))
    cands = torch.from_numpy(rng.normal(size=(L, n)).astype(np.float32)).cuda()
    d = placed((rng.uniform(size=m) * 4.0 * n).astype(np.float32))
    return x, cands, d


def check_kpp_against_plain(x, cands, d, newd, pot):
    from repro_torch.kernels import kpp_probe as kpp

    want_newd, want_pot = kpp.kpp_probe_plain(x, cands, d)
    terms = (x.norm(dim=1)[:, None] + cands.norm(dim=1)[None, :]) ** 2
    assert bool(((newd - want_newd).abs() <= RTOL * terms).all())
    assert bool(((pot - want_pot).abs() <= RTOL * want_pot.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KPP_CARD_SHAPES, ids=[
    f"m{m}-n{n}-L{L}" + (f"-off{o}" if o else "")
    for m, n, L, o in KPP_CARD_SHAPES])
def test_kpp_probe_matches_plain_on_card(shape):
    """Kernel P against ``kpp_probe_plain``: newd within RTOL of its
    terms' magnitude (||x|| + ||c||)^2, pot within RTOL, two launches
    bitwise equal; ``kpp_probe`` on the card is the kernel, counted."""
    _card()
    from repro_torch.kernels import kpp_probe as kpp
    from repro_torch.kernels import ops

    x, cands, d = kpp_card_inputs(*shape)
    ops.reset_launch_counts()
    newd, pot = kpp.kpp_probe(x, cands, d)
    newd2, pot2 = kpp.kpp_probe_cuda(x, cands, d)
    assert ops.launch_counts()["kpp_probe"] == 2
    assert torch.equal(newd, newd2) and torch.equal(pot, pot2)
    check_kpp_against_plain(x, cands, d, newd, pot)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64_000, 28, 3, 0), (3000, 70, 5, 0)],
                         ids=["seeding", "feature-tiles"])
def test_kpp_probe_graph_replay_on_card(shape):
    """P's one launch in a CUDA graph, replayed twice: both replays bitwise
    equal to each other and to an eager launch (the graph holds the
    launch's own ticket and the memset that zeroes it)."""
    _card()
    from repro_torch.kernels import kpp_probe as kpp

    x, cands, d = kpp_card_inputs(*shape)
    eager = kpp.kpp_probe_cuda(x, cands, d)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kpp.kpp_probe_cuda(x, cands, d)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # the ticket made above
        newd, pot = kpp.kpp_probe_cuda(x, cands, d)
    replays = []
    for _ in range(2):
        newd.fill_(float("nan"))
        pot.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        replays.append((newd.clone(), pot.clone()))
    for got in replays:
        assert torch.equal(got[0], eager[0]) and torch.equal(got[1], eager[1])
    check_kpp_against_plain(x, cands, d, *replays[-1])


@pytest.mark.cuda
def test_kpp_probe_two_graphs_on_two_streams_on_card():
    """Two graphs of P captured on one stream and replayed at once on two
    other streams, 200 times each: every replay's pot bitwise a lone
    launch's, and newd too.  Each launch owns its ticket; a ticket shared
    by the two captures (one per capture stream) would let one replay's
    CTAs be counted by the other's and pick a wrong last CTA."""
    _card()
    from repro_torch.kernels import kpp_probe as kpp

    x, cands, d = kpp_card_inputs(64_000, 28, 3)
    newd0, pot0 = kpp.kpp_probe_cuda(x, cands, d)
    cap = torch.cuda.Stream()
    cap.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(cap):
        kpp.kpp_probe_cuda(x, cands, d)
    graphs = []
    for _ in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=cap):
            out = kpp.kpp_probe_cuda(x, cands, d)
        graphs.append((graph, out))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    pots = [torch.full((200, 3), float("nan"), device="cuda")
            for _ in graphs]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
        st.wait_stream(cap)
    for i in range(200):
        for (graph, (_, pot)), st, rec in zip(graphs, streams, pots):
            with torch.cuda.stream(st):
                graph.replay()
                rec[i].copy_(pot)
    torch.cuda.synchronize()
    for (_, (newd, _)), rec in zip(graphs, pots):
        assert torch.equal(rec, pot0.expand_as(rec))
        assert torch.equal(newd, newd0)


SEED_CARD_SHAPES = [(64_000, 25, 28), (16_384, 256, 768)]  # (s, k, n)


def seed_card_points(s, n, data):
    """Points on the card: 'exact', integers (0..2 at n <= 32, else 0..1)
    whose distances and their sums over the rows are exact in f32 in any
    order (below 2**24); 'gauss', standard normal."""
    gen = torch.Generator(device="cuda").manual_seed(s + n)
    if data == "exact":
        hi = 3 if n <= 32 else 2
        return torch.randint(0, hi, (s, n), generator=gen,
                             device="cuda").float()
    return torch.randn(s, n, generator=gen, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64_000, 28, 3), (163_840, 768, 3),
                                   (1000, 7, 128), (5000, 28, 3)],
                         ids=["seeding", "codebook", "L128", "zeros"])
def test_kpp_draw_matches_plain_on_card(shape):
    """Kernel G against ``kpp_draw_plain`` on the same d and noise: the
    candidates' rows and the candidates bitwise; the next slot's draw
    makes the pick of the last (the least of P's potentials, its
    candidate into the centroid row, newd's column into d), the last
    pick alone after it; each launch counted."""
    _card()
    from repro_torch.kernels import kpp_probe as kpp
    from repro_torch.kernels import ops

    s, n, L = shape
    gen = torch.Generator(device="cuda").manual_seed(s)
    x = torch.randn(s, n, generator=gen, device="cuda")
    d = 4.0 * n * torch.rand(s, generator=gen, device="cuda")
    if s == 5000:
        d.zero_()                         # no distance: a uniform draw
    c = torch.zeros(4, n, device="cuda")
    ops.reset_launch_counts()
    chain = kpp.SlotChain(x, d, c, L)
    for j in (1, 3):
        d0 = d.clone()
        noise = torch.empty(L, s, device="cuda").exponential_(
            generator=gen).log_().neg_()
        if j == 3:
            b = int(torch.argmin(chain.pot))
            newd, prev = chain.newd.clone(), chain.cands.clone()
        chain.slot(noise, j)
        if j == 3:
            assert torch.equal(d, newd[:, b]) and torch.equal(c[1], prev[b])
            d0 = newd[:, b]
        idx, cands = kpp.kpp_draw_plain(x, noise, d0)
        assert torch.equal(chain.idx, idx) and torch.equal(chain.cands, cands)
    prev = chain.cands.clone()
    b = int(torch.argmin(chain.pot))
    chain.finish()
    assert torch.equal(c[3], prev[b])
    assert not bool(c[0].any()) and not bool(c[2].any())
    counts = ops.launch_counts()
    assert counts["kpp_draw"] == 3 and counts["kpp_probe"] == 2


def _seed_pair(x, k, key, init=None, degenerate=None):
    """The seeding on the slot kernels and on the oracle chain, same key."""
    from repro_torch.core import kmeanspp

    kw = {"init": init, "degenerate": degenerate}
    return (kmeanspp.seed(x, key, k, **kw),
            kmeanspp.seed(x, key, k, impl="ref", **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SEED_CARD_SHAPES,
                         ids=["hepmass", "wide"])
def test_seed_slot_kernels_bitwise_oracle_chain_on_exact_data_on_card(shape):
    """On integer points every distance and potential is exact in f32 in
    either association (P's ``(c2 - 2 dots) + x2``, the oracle chain's
    ``x2 - 2 dots + c2``), so ``seed`` on the slot kernels is bitwise the
    oracle chain (``impl="ref"``) under the same keys: fresh, and
    re-seeding every other slot.  Launches: P a seeded slot, G a seeded
    slot and one more a seeding; the oracle chain launches neither."""
    _card()
    from repro_torch import random as rnd
    from repro_torch import tracing
    from repro_torch.kernels import ops

    s, k, n = shape
    x = seed_card_points(s, n, "exact")
    ops.reset_launch_counts()
    tracing.snapshot()
    tracing.enable(True)
    try:
        got, want = _seed_pair(x, k, rnd.TORCH.key(s))
        deg = torch.arange(k, device="cuda") % 2 == 0
        got2, want2 = _seed_pair(x, k, rnd.TORCH.key(s + 1), init=got,
                                 degenerate=deg)
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.enable(False)
    assert torch.equal(got, want) and torch.equal(got2, want2)
    assert torch.equal(got2[1::2], got[1::2])
    slots = k + (k + 1) // 2
    counts = ops.launch_counts()
    assert counts["kpp_probe"] == slots and counts["kpp_draw"] == slots + 2
    assert counters["core.kmeanspp.probe.kernel"] == slots
    assert counters["core.kmeanspp.probe.plain"] == slots


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SEED_CARD_SHAPES,
                         ids=["hepmass", "wide"])
def test_seed_slot_kernels_pick_the_best_candidate_on_card(shape,
                                                           monkeypatch):
    """On Gaussian points each slot's pick, its potential recomputed in
    float64 from the centroids chosen before it, is within 1e-5 of the
    least potential of the slot's L candidates (recorded from kernel G)."""
    _card()
    from repro_torch import random as rnd
    from repro_torch.core import kmeanspp
    from repro_torch.kernels import kpp_probe as kpp

    s, k, n = shape
    x = seed_card_points(s, n, "gauss")
    drawn = []

    class Recording(kpp.SlotChain):
        def slot(self, noise, j):
            super().slot(noise, j)
            drawn.append(self.cands.clone())

    monkeypatch.setattr(kpp, "SlotChain", Recording)
    c = kmeanspp.seed(x, rnd.TORCH.key(s), k)
    assert len(drawn) == k
    x64 = x.double()
    d64 = torch.full((s,), math.inf, dtype=torch.float64, device="cuda")

    def potentials(cands):
        dist = torch.cdist(x64, cands.double()) ** 2            # [s, L]
        return torch.minimum(d64[:, None], dist).sum(0), dist

    for j, cands in enumerate(drawn):
        pot, _ = potentials(cands)
        picked, dist = potentials(c[j:j + 1])
        assert float(picked[0]) <= float(pot.min()) * (1 + 1e-5), j
        assert bool((cands == c[j]).all(dim=1).any()), j
        d64 = torch.minimum(d64, dist[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SEED_CARD_SHAPES,
                         ids=["hepmass", "wide"])
def test_seed_slot_kernels_never_sync_on_card(shape):
    """A fresh seeding on the slot kernels under
    ``torch.cuda.set_sync_debug_mode("error")`` raises nothing: the host
    reads no mask (it makes it) and no pick."""
    _card()
    from repro_torch import random as rnd
    from repro_torch.core import kmeanspp

    s, k, n = shape
    x = seed_card_points(s, n, "gauss")
    want = kmeanspp.seed(x, rnd.TORCH.key(s), k)        # builds, warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kmeanspp.seed(x, rnd.TORCH.key(s), k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


@pytest.fixture
def _tuner(tmp_path):
    from repro_torch.kernels import autotune

    was = autotune.enabled(), autotune.cache_path()
    autotune.clear()
    autotune.set_cache_path(tmp_path / "tune.json")
    yield autotune
    autotune.clear()
    autotune.enable(was[0])
    autotune.set_cache_path(was[1])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8", "bf16", "bf16x3"])
def test_tuned_fused_step_bitwise_untuned_on_card(_tuner, tmp_path,
                                                  precision):
    """A tuned ``ops.fused_step`` (both pipelines timed, the winner cached
    under a ``cuda-sm_*`` key) is bitwise the untuned one, and so is a
    launch under a pinned ``{"pipeline": "dma"}``."""
    _card()
    from repro_torch.kernels import ops

    xn, cn = blobs(64_000, 25, 28, seed=12)
    x, c = torch.from_numpy(xn).cuda(), torch.from_numpy(cn).cuda()
    untuned = ops.fused_step(x, c, precision=precision)
    _tuner.enable(True)
    n_timed = len(_tuner.timings())
    tuned = ops.fused_step(x, c, precision=precision)
    timed = _tuner.timings()[n_timed:]
    assert [cand for _, cand, _ in timed] == [{"pipeline": "blocks"},
                                              {"pipeline": "dma"}]
    assert timed[0][0].split("|")[1] == ops.tune_backend(x.device)
    assert all(torch.equal(a, b) for a, b in zip(untuned, tuned))
    _tuner.enable(False)
    _tuner.clear()
    pin = tmp_path / "pin.json"
    pin.write_text(json.dumps({"version": 1, "entries": {
        timed[0][0]: {"pipeline": "dma"}}}))
    _tuner.set_cache_path(pin)
    ops.reset_launch_counts()
    pinned = ops.fused_step(x, c, precision=precision)
    suffix = "" if precision == "f32" else f"_{precision}"
    assert ops.launch_counts()["fused_step_dma" + suffix] == 1
    assert all(torch.equal(a, b) for a, b in zip(untuned, pinned))


MMA_CARD_SHAPES = [(64_000, 25, 28), (16_384, 2048, 1024),
                   (64_001, 130, 68), (2_001, 300, 1100)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MMA_CARD_SHAPES, ids=[
    f"m{m}-k{k}-n{n}" for m, k, n in MMA_CARD_SHAPES])
def test_tensor_core_assign_kernels_on_card(shape):
    """Kernels B8, B16 and B3 (wgmma products with a fused argmin) at the
    main path's shape, the two-pass route's, and two shapes whose rows are
    off 16 bytes: B8 bitwise its plain version (d everywhere; ids the first
    minimum of the plain scores, and the plain ids off near ties), B16's
    and B3's ids equal to the plain ids off near ties with d within the
    f32 norm bound; all bitwise on a repeat and with 1 or 4 persistent
    CTAs per SM instead of 2."""
    _card()
    from repro_torch.kernels import distance
    from repro_torch.kernels import precision as px

    m, k, n = shape
    xn, cn = blobs(m, k, n, seed=17)
    x, c = torch.from_numpy(xn).cuda(), torch.from_numpy(cn).cuda()
    qx = px.quantize_chunk(x)
    ids, d = distance.assign_int8(qx, c)
    pids, pd = distance.assign_int8_plain(qx, c)
    cq, t = px.quantize_centroids(c, qx.scale)
    scores = px.sqnorm_in_order(c)[None, :] - 2.0 * (
        px.intdot(qx.q, cq, ([1], [1])).float() * t[None, :])
    assert torch.equal(ids, torch.argmin(scores, 1).int())
    assert torch.equal(d, pd)
    ties8 = near_ties_int8(qx, c)
    assert torch.equal(ids[~ties8], pids[~ties8])

    xb = x.bfloat16()
    ids16, d16 = distance.assign_16(xb, c, "bf16")
    pids16, pd16 = distance.assign_plain(xb, c, "bf16")
    ties16 = near_ties_16(xb, c, "bf16")
    assert torch.equal(ids16[~ties16], pids16[~ties16])
    xs = xb.float().cpu().numpy()
    assert np.all((d16 - pd16).abs().cpu().numpy()
                  <= d_bound(xs, cn, pids16.cpu().numpy()) + 1e-6)

    ids3, d3 = distance.assign_16(x, c, "bf16x3")
    pids3, pd3 = distance.assign_plain(x, c, "bf16x3")
    ties3 = near_ties_16(x, c, "bf16x3")
    assert torch.equal(ids3[~ties3], pids3[~ties3])
    assert np.all((d3 - pd3).abs().cpu().numpy()
                  <= d_bound(xn, cn, pids3.cpu().numpy()) + 1e-6)

    for per_sm in (2, 1, 4):
        for got, want in ((distance.assign_int8(qx, c, ctas_per_sm=per_sm),
                           (ids, d)),
                          (distance.assign_16(xb, c, "bf16",
                                              ctas_per_sm=per_sm),
                           (ids16, d16)),
                          (distance.assign_16(x, c, "bf16x3",
                                              ctas_per_sm=per_sm),
                           (ids3, d3))):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


F32_CARD_SHAPES = MMA_CARD_SHAPES + [(262_144, 2048, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_CARD_SHAPES, ids=[
    f"m{m}-k{k}-n{n}" for m, k, n in F32_CARD_SHAPES])
def test_register_tiled_assign_kernel_on_card(shape):
    """Kernel B (a register-tiled fp32 product on the CUDA cores with a
    fused argmin) at the tensor-core kernels' shapes and at one
    ``evaluate`` batch of the two-pass data (262,144 rows): ids equal to
    the plain ids off near ties, d within the f32 norm bound, and bitwise
    on a repeat and with 1 or 4 persistent CTAs per SM instead of 2."""
    _card()
    from repro_torch.kernels import distance

    m, k, n = shape
    xn, cn = blobs(m, k, n, seed=19)
    x, c = torch.from_numpy(xn).cuda(), torch.from_numpy(cn).cuda()
    ids, d = distance.assign_f32(x, c)
    pids, pd = distance.assign_plain(x, c)
    ties = _near_ties(x, c)
    assert torch.equal(ids[~ties], pids[~ties])
    assert np.all((d - pd).abs().cpu().numpy()
                  <= d_bound(xn, cn, pids.cpu().numpy()) + 1e-6)
    for per_sm in (2, 1, 4):
        got = distance.assign_f32(x, c, ctas_per_sm=per_sm)
        assert torch.equal(got[0], ids) and torch.equal(got[1], d)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8", "bf16", "bf16x3"])
def test_assign_candidates_bitwise_each_other_on_card(precision):
    """Kernel B's launches at 1, 2 and 4 CTAs per SM (the tuner's assign
    candidates) give bitwise the same ids and distances."""
    _card()
    from repro_torch.kernels import autotune, distance
    from repro_torch.kernels import precision as px

    xn, cn = blobs(64_001, 25, 28, seed=13)
    x, c = torch.from_numpy(xn).cuda(), torch.from_numpy(cn).cuda()
    xs = px.cast_storage(x, precision)
    kernel = {"f32": distance.assign_f32, "int8": distance.assign_int8}.get(
        precision, lambda a, b, **kw: distance.assign_16(a, b, precision,
                                                         **kw))
    outs = [kernel(xs, c, **cand) for cand in autotune.candidates(
        "assign", b=1, m=64_001, k=25, n=28, precision=precision)]
    for ids, d in outs[1:]:
        assert torch.equal(ids, outs[0][0]) and torch.equal(d, outs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8", "bf16", "bf16x3"])
@pytest.mark.parametrize("batch", [1, 4], ids=["sequential", "batched"])
def test_autotuned_fit_bitwise_untuned_on_card(_tuner, batch, precision):
    """fit(autotune=True) on the card is bitwise fit(autotune=False) under
    each policy, and leaves tuning off."""
    _card()
    from repro_torch import api
    from repro_torch.data.synthetic import GMMSpec, gmm_dataset

    X = gmm_dataset(GMMSpec(m=300_000, n=28, components=25, seed=1))
    cfg = api.BigMeansConfig(k=25, s=8192, n_chunks=8, batch=batch,
                             sync_every=2, precision=precision)
    plain = api.fit(X, cfg)
    tuned = api.fit(X, cfg, autotune=True)
    assert not _tuner.enabled()
    assert torch.equal(tuned.centroids, plain.centroids)
    assert tuned.trace == plain.trace


def _slow_consumer():
    """A middleware that holds the stream loop's consumer back on each
    chunk, on the host and on the card's compute stream, so the prefetch
    worker runs ahead."""
    import time

    from repro_torch.engine import middleware as mw

    class SlowConsumer(mw.Middleware):
        def transform_chunk(self, ctx, cid, chunk):
            time.sleep(0.005)
            torch.cuda._sleep(5_000_000)
            return chunk

    return SlowConsumer()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8", "bf16", "bf16x3"])
@pytest.mark.parametrize("batch", [1, 4], ids=["fold", "persistent"])
def test_streaming_prefetch_bitwise_sync_on_card(tmp_path, batch, precision):
    """The pinned-buffer pipeline on the copy stream changes nothing:
    fit(path) with prefetch=2 is bitwise prefetch=0, also with a consumer
    held back on every chunk, and the chunks it stages are the provider's
    (bf16: its bits; int8: the dequantized codes)."""
    _card()
    from repro_torch import api
    from repro_torch.data.synthetic import GMMSpec, gmm_memmap
    from repro_torch.engine import middleware as mw
    from repro_torch.engine import stream

    path = str(tmp_path / "x.npy")
    gmm_memmap(GMMSpec(m=200_000, n=28, components=25, seed=2), path)
    cfg = api.BigMeansConfig(k=25, s=8192, n_chunks=12, batch=batch,
                             sync_every=2, precision=precision, log_every=1)
    fetched = api.fit(path, cfg)
    assert fetched.strategy == "streaming"
    assert len(fetched.extras["pipeline"]["copy_ms"]) == 12
    serial = api.fit(path, cfg, prefetch=0)
    fetch = api.MemmapSource(path).provider(cfg.s, seed=cfg.seed)
    slow, _ = stream.run_stream(
        fetch, cfg, n_features=28,
        middlewares=[*mw.default_stack(cfg), _slow_consumer()])
    for other in (serial.centroids, slow.centroids):
        assert torch.equal(other, fetched.centroids)
    assert serial.trace == fetched.trace
    assert float(slow.f_best) == fetched.objective

    arr = fetch(3)
    stats = stream.RunnerMetrics().pipeline
    st = stream._Stager(torch.device("cuda"), precision, stats)
    got = st.ship(st.prepare(arr)).take()
    plain = stream._Stager(torch.device("cpu"), precision, stats)
    want = plain.ship(plain.prepare(arr)).take()
    assert got.is_cuda and got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_kernel_failure_raises_then_fit_is_bitwise_on_card():
    """No demotion: inside ``kernel_failure("fused")`` a fit on the card
    raises the injected error (for every policy's fused kernel); after the
    context the same fit is bitwise the fit before it."""
    _card()
    from repro_torch import api
    from repro_torch.engine import faults

    x, _ = blobs(20_000, 25, 28, seed=4)
    cfg = api.BigMeansConfig(k=25, s=4096, n_chunks=4, seed=1)
    before = api.fit(x, cfg)
    for precision in ("f32", "int8", "bf16", "bf16x3"):
        with faults.kernel_failure("fused"):
            with pytest.raises(RuntimeError,
                               match="injected fused kernel failure"):
                api.fit(x, cfg, precision=precision)
    after = api.fit(x, cfg)
    assert torch.equal(after.centroids, before.centroids)
    assert after.trace == before.trace and after.objective == before.objective
    assert after.health is None


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_competitive_s_prefetch_bitwise_on_card(tmp_path, precision):
    """``scheduler="competitive_s"`` on the card (streams of three sizes,
    scored by B, or B16 on the bf16 eval chunk): ``prefetch=2`` bitwise
    ``prefetch=0``."""
    _card()
    from repro_torch import api
    from repro_torch.data.synthetic import GMMSpec, gmm_memmap
    from repro_torch.kernels import ops

    path = str(tmp_path / "x.npy")
    gmm_memmap(GMMSpec(m=200_000, n=28, components=25, seed=2), path)
    cfg = api.BigMeansConfig(k=25, s=4096, n_chunks=16, batch=4,
                             sync_every=2, scheduler="competitive_s",
                             precision=precision, log_every=1)
    ops.reset_launch_counts()
    fetched = api.fit(path, cfg)
    scored = ops.launch_counts()["assign_bf16" if precision == "bf16"
                                 else "assign"]
    serial = api.fit(path, cfg, prefetch=0)
    assert fetched.extras["competitive_s"]["ladder"] == (2048, 4096, 8192)
    assert fetched.extras["competitive_s"] == serial.extras["competitive_s"]
    assert torch.equal(serial.centroids, fetched.centroids)
    assert serial.trace == fetched.trace
    assert serial.objective == fetched.objective
    # 4 rounds: a reduce each, 2 windows (observe + exchange), a final
    # reduce, each scoring the 4 streams; f32 adds 16 epilogue assigns
    assert scored == 4 * (4 + 2 * 2 + 1) + (16 if precision == "f32" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8", "bf16", "bf16x3"])
def test_streaming_resume_bitwise_uninterrupted_on_card(tmp_path, precision):
    """A sequential streaming fit on the card split in two (8 chunks with
    ``resume=False``, then resumed to 16) is bitwise the uninterrupted
    16-chunk fit: centroids, objective, ``n_d``, the accepts of chunks
    8-15 and the checkpoint steps."""
    _card()
    from repro_torch import api
    from repro_torch.cluster import checkpoint
    from repro_torch.data.synthetic import GMMSpec, gmm_memmap

    path = str(tmp_path / "x.npy")
    gmm_memmap(GMMSpec(m=200_000, n=28, components=25, seed=2), path)
    cfg = api.BigMeansConfig(k=25, s=8192, n_chunks=16, precision=precision,
                             log_every=1, ckpt_every=3)
    d_full, d_split = str(tmp_path / "full"), str(tmp_path / "split")
    full = api.fit(path, cfg.replace(ckpt_dir=d_full))
    first = api.fit(path, cfg.replace(ckpt_dir=d_split, n_chunks=8,
                                      resume=False))
    resumed = api.fit(path, cfg.replace(ckpt_dir=d_split))
    assert first.n_chunks == resumed.n_chunks == 8
    assert torch.equal(resumed.centroids, full.centroids)
    assert resumed.objective == full.objective
    assert resumed.n_dist_evals == full.n_dist_evals
    assert first.n_accepted + resumed.n_accepted == full.n_accepted
    assert resumed.trace == [t for t in full.trace if t[0] >= 8]
    assert checkpoint.steps(d_split) == checkpoint.steps(d_full) == [12, 15,
                                                                      16]
    assert len(resumed.extras["checkpoint"]["restore_ms"]) == 1


@pytest.mark.cuda
def test_checkpoint_from_card_restores_on_both_devices(tmp_path):
    """A state saved from the card (one packed device read) restores with
    ``device="cpu"`` and ``device="cuda"`` bitwise, in the stored dtypes;
    the key leaf stays numpy."""
    _card()
    from repro_torch import random as rnd
    from repro_torch.cluster import checkpoint
    from repro_torch.core import bigmeans

    x, c = blobs(4096, 25, 28, seed=5)
    state = bigmeans.BigMeansState(
        centroids=torch.from_numpy(c).cuda(),
        degenerate=torch.arange(25, device="cuda") % 3 == 0,
        f_best=torch.tensor(1234.5, device="cuda"),
        n_accepted=torch.tensor(7, dtype=torch.int32, device="cuda"),
        n_dist_evals=torch.tensor(3.5e9, device="cuda"))
    key = rnd.TORCH.key_to_array(rnd.TORCH.key(11))
    payload = ((state, key), np.asarray([1, 2, 4096], np.int64))
    checkpoint.save(str(tmp_path), 4, payload)
    for device in ("cpu", "cuda"):
        ((got, k), aux), step = checkpoint.restore(str(tmp_path), payload,
                                                   device=device)
        assert step == 4 and isinstance(k, np.ndarray)
        np.testing.assert_array_equal(k, key)
        np.testing.assert_array_equal(aux, [1, 2, 4096])
        for g, w in zip(got, state):
            assert g.device.type == device and g.dtype == w.dtype
            assert torch.equal(g.cpu(), w.cpu())


# ---------------------------------------------------------------------------
# serving: one CUDA graph per bucket


SERVE_POLICIES = ["f32", "int8", "bf16", "bf16x3"]


def _serving(precision, k=25, n=28, **overrides):
    from repro_torch.serve import ServeConfig, serve

    _, c = blobs(16, k, n, seed=7)
    cfg = ServeConfig(min_bucket=64, max_batch=512, **overrides)
    return serve({"m": c}, cfg, precision=precision), c, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("precision", SERVE_POLICIES)
def test_serve_captures_one_graph_per_bucket_replay_bitwise_eager(precision):
    """Registration captures each bucket once; each bucket's replay is
    bitwise an eager launch of the policy on the same rows, and counts one
    launch of the policy's kernel: the capture recorded exactly that, and
    counts none itself."""
    _card()
    from repro_torch.kernels import ops

    srv, c, cfg = _serving(precision)
    with srv:
        entry = srv.registry.get("m")
        snap = entry.snapshot()
        assert srv.recompiles("m") == len(cfg.buckets()) == 4
        ops.reset_launch_counts()
        for b in cfg.buckets():
            x, _ = blobs(b, 25, 28, seed=b)
            buf = entry.host_buffer(b)
            assert buf.is_pinned()
            buf.copy_(torch.from_numpy(x))
            ids, d = entry.launch(buf, snap)
            ids_e, d_e = ops.assign(torch.from_numpy(x).cuda(),
                                    snap.centroids, precision=precision)
            assert np.array_equal(ids, ids_e.cpu().numpy())
            assert np.array_equal(d, d_e.cpu().numpy())
        kernel = ops.ASSIGN_COUNTERS[precision]
        for b in cfg.buckets():
            assert entry.plan(b).launches == {kernel: 1}
        counts = ops.launch_counts()
        assert counts[kernel] == 2 * len(cfg.buckets())   # replays + eager
        assert sum(counts.values()) == counts[kernel]
        assert srv.recompiles("m") == len(cfg.buckets())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x3"])
def test_serve_coalesced_bitwise_per_request_on_card(precision):
    """Coalesced launches give bitwise each request served alone: kernels
    B, B16 and B3 compute every row by itself."""
    _card()
    reqs = [blobs(m, 25, 28, seed=100 + m)[0]
            for m in (3, 48, 64, 65, 100, 1, 200, 31)]
    srv, _, _ = _serving(precision, max_linger_ms=0.0)
    with srv:
        alone = [srv.assign("m", p) for p in reqs]
    srv, _, _ = _serving(precision, max_linger_ms=100.0)
    with srv:
        futs = [srv.submit("m", p) for p in reqs]
        coalesced = [f.result(timeout=60) for f in futs]
        assert srv.recompiles("m") == 4
    assert any(r.n_coalesced > 1 for r in coalesced)
    for a, r in zip(alone, coalesced):
        assert np.array_equal(a.ids, r.ids)
        assert np.array_equal(a.dists, r.dists)


@pytest.mark.cuda
def test_launch_counts_lose_nothing_across_threads():
    """A fit's kernel wrappers count on one thread while a server adds its
    replays' counts (``ops.add_launch_counts``) on another, the interpreter
    switching threads every microsecond: no launch is lost from the
    counts."""
    _card()
    from repro_torch.kernels import ops

    x, c = blobs(512, 8, 4, seed=5)
    x, c = torch.from_numpy(x).cuda(), torch.from_numpy(c).cuda()
    n = 3000
    ops.assign(x, c, impl="cuda")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ops.reset_launch_counts()
        adder = threading.Thread(target=lambda: [
            ops.add_launch_counts({"assign": 1}) for _ in range(n)])
        adder.start()
        for _ in range(n):
            ops.assign(x, c, impl="cuda")
        adder.join(timeout=120)
        assert not adder.is_alive()
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert ops.launch_counts()["assign"] == 2 * n


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8", "bf16", "bf16x3"])
def test_tally_names_the_counter_each_wrapper_counts(precision):
    """Every wrapper of the policy (B·, C·, A· and its dma twin, D·; P
    beside f32) notes in this thread's ``build.tally`` exactly what it adds
    to ``ops.launch_counts``."""
    _card()
    from repro_torch.kernels import build, kpp_probe, ops
    from repro_torch.kernels import precision as px

    x, c = blobs(512, 8, 16, seed=2)
    x, c = torch.from_numpy(x).cuda(), torch.from_numpy(c).cuda()
    xs = px.cast_storage(px.as_quantized(x) if precision == "int8" else x,
                         precision)
    xb = torch.stack([x, x.flip(0)])
    xbs = px.cast_storage(px.as_quantized(xb) if precision == "int8"
                          else xb, precision)
    ids = torch.zeros(512, dtype=torch.int32, device="cuda")
    table = ops._KERNELS[precision]
    calls = [lambda: table["assign"](xs, c),
             lambda: table["update"](xs, ids, 8),
             lambda: table["fused"](xs, c),
             lambda: table["fused"](xs, c, pipeline="dma"),
             lambda: table["batched"](xbs, torch.stack([c, c]))]
    if precision == "f32":
        calls.append(lambda: kpp_probe.kpp_probe_cuda(
            x, c[:4], torch.ones(512, device="cuda")))
    for call in calls:
        call()                                  # built and tuned
        torch.cuda.synchronize()
        before = ops.launch_counts()
        with build.tally() as launched:
            call()
        after = ops.launch_counts()
        assert launched == {k: v - before[k] for k, v in after.items()
                            if v != before[k]} != {}


@pytest.mark.cuda
def test_capture_counts_none_of_a_concurrent_fit():
    """Tenants registered (each bucket captured) while a fit launches on
    another thread: every capture counts its one B launch, and the counts
    after both are the fit's launches plus one eager warmup launch a
    bucket, none lost and none added (the fit's seeding launches, G and P,
    read from the same fit run again alone)."""
    _card()
    from repro_torch.api import BigMeansConfig, fit
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, Server

    x, c = blobs(20_000, 10, 12, seed=4)
    x = torch.from_numpy(x).cuda()
    cfg = BigMeansConfig(k=10, s=2048, n_chunks=40, seed=0)
    fit(x, cfg.replace(n_chunks=2))
    ops.reset_launch_counts()
    results = []
    fitter = threading.Thread(target=lambda: results.append(fit(x, cfg)))
    srv = Server(ServeConfig(min_bucket=64, max_batch=1024))
    n_tenants = 6
    with srv:
        fitter.start()
        for i in range(n_tenants):
            srv.register(f"t{i}", np.roll(c, i, axis=0))
        fitter.join(timeout=300)
        assert not fitter.is_alive()
        buckets = srv.config.buckets()
        for i in range(n_tenants):
            entry = srv.registry.get(f"t{i}")
            assert all(entry.plan(b).launches == {"assign": 1}
                       for b in buckets)
    torch.cuda.synchronize()
    res, = results
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    ops.reset_launch_counts()
    alone = fit(x, cfg)
    seeding = {k: v for k, v in ops.launch_counts().items()
               if k in ("kpp_probe", "kpp_draw")}
    assert alone.trace == res.trace
    assert seeding["kpp_draw"] > seeding["kpp_probe"] > 0
    assert counts == {"fused_step": res.n_iterations,
                      "update": res.n_chunks,
                      "assign": res.n_chunks + n_tenants * len(buckets),
                      **seeding}


@pytest.mark.cuda
def test_serve_swap_captures_nothing_on_card():
    """A swap is one device copy at the next launch: no capture, and the
    responses follow the generation they name."""
    _card()
    from repro_torch.kernels import ops

    srv, c, _ = _serving("f32")
    with srv:
        x, _ = blobs(48, 25, 28, seed=3)
        c1 = np.roll(c, 1, axis=0)
        r0 = srv.assign("m", x)
        srv.swap("m", c1, step=9)
        r1 = srv.assign("m", x)
        assert srv.recompiles("m") == 4
        assert (r0.version, r1.version, r1.step) == (0, 1, 9)
        for r, cc in ((r0, c), (r1, c1)):
            xp = torch.zeros((64, 28), device="cuda")
            xp[:48] = torch.from_numpy(x).cuda()
            ids, d = ops.assign(xp, torch.from_numpy(cc).cuda())
            assert np.array_equal(r.ids, ids[:48].cpu().numpy())
            assert np.array_equal(r.dists, d[:48].cpu().numpy())


@pytest.mark.cuda
def test_wrap_launch_runs_on_a_device_launch():
    """``FaultPlan.wrap_launch`` around a launch on the card: a poisoned
    request fails alone (bisection), transients recover by replaying the
    bucket's graph (bitwise a healthy launch; the plain fallback is never
    taken), and the breaker stays closed."""
    _card()
    from repro_torch.engine import faults
    from repro_torch.serve import LaunchFault

    srv, c, _ = _serving("f32", launch_retries=1, demote_after=0)
    with srv:
        entry = srv.registry.get("m")
        healthy = entry.launch
        entry.launch = faults.FaultPlan(
            seed=0, launch_transient_rate=0.5).wrap_launch(entry.launch)
        bad = blobs(8, 25, 28, seed=1)[0]
        bad[3, 3] = np.nan
        with pytest.raises(LaunchFault):
            srv.assign("m", bad, validate=False)
        for i in range(8):
            x = blobs(20, 25, 28, seed=i)[0]
            r = srv.assign("m", x)
            buf = entry.host_buffer(64)
            buf.zero_()
            buf[:20] = torch.from_numpy(x)
            ids, d = healthy(buf, entry.snapshot())
            assert np.array_equal(r.ids, ids[:20])
            assert np.array_equal(r.dists, d[:20])
        stats = srv.stats("m")
        assert stats["n_ref_retries"] > 0 and stats["n_failed"] == 1
        assert srv.health()["models"]["m"]["breaker"]["state"] == "closed"
        assert entry.launch.calls["n"] >= 9


@pytest.mark.cuda
def test_serve_demoted_bucket_fails_on_card():
    """A bucket demoted on the card has no plain route: its requests fail
    with ``LaunchFault`` and feed the breaker, and the fallback is never
    run; other buckets go on serving from their graphs."""
    _card()
    from repro_torch.engine import faults
    from repro_torch.serve import LaunchFault

    srv, c, _ = _serving("f32", launch_retries=1, demote_after=2)
    with srv:
        entry = srv.registry.get("m")
        healthy = entry.launch
        flaky = faults.FaultPlan(seed=0, launch_transient_rate=1.0
                                 ).wrap_launch(healthy)

        def on_small(q, snap):
            return (flaky if q.shape[0] == 64 else healthy)(q, snap)

        entry.launch = on_small
        for i in range(2):                      # retried, then demoted
            srv.assign("m", blobs(20, 25, 28, seed=i)[0])
        assert entry.demoted_buckets == (64,)
        with pytest.raises(LaunchFault, match="demoted"):
            srv.assign("m", blobs(20, 25, 28, seed=5)[0])
        with pytest.raises(RuntimeError, match="no plain fallback"):
            entry.launch_fallback(entry.host_buffer(64), entry.snapshot())
        r = srv.assign("m", blobs(100, 25, 28, seed=6)[0])
        assert r.batch_rows == 128 and np.isfinite(r.dists).all()
        stats = srv.stats("m")
        assert stats["n_failed"] == 1 and stats["n_ref_retries"] == 2
        assert srv.health()["models"]["m"]["demoted_buckets"] == [64]


@pytest.mark.cuda
def test_weighted_step_runs_kernel_b_on_card():
    """A weighted Lloyd step on the card never enters a fused kernel: its
    ids and d come from kernel B (one launch), its sums and counts from the
    weighted contraction; the plain twin agrees (same ids on blobs, so the
    same contraction bitwise; the objective within RTOL)."""
    _card()
    from repro_torch.core import kmeans
    from repro_torch.kernels import ops

    x, c = blobs(4000, 25, 28, seed=7)
    w = np.random.default_rng(7).uniform(0.1, 4.0, 4000).astype(np.float32)
    xt, ct, wt = (torch.from_numpy(a).cuda() for a in (x, c, w))
    ops.reset_launch_counts()
    sums, counts, f = ops.fused_step(xt, ct, weights=wt)
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "assign": 1}
    s_ref, n_ref, f_ref = ops.fused_step(xt, ct, weights=wt, impl="ref")
    assert torch.equal(sums, s_ref) and torch.equal(counts, n_ref)
    assert abs(float(f) - float(f_ref)) <= RTOL * abs(float(f_ref))
    ops.reset_launch_counts()
    res = kmeans.lloyd(xt, ct, weights=wt)
    launches = ops.launch_counts()
    assert launches["fused_step"] == 0
    assert launches["assign"] == res.iterations + 1
    want = kmeans.lloyd(xt, ct, weights=wt, impl="ref")
    assert res.iterations == want.iterations
    assert torch.equal(res.assignments, want.assignments)
    assert abs(float(res.objective) - float(want.objective)) <= (
        RTOL * abs(float(want.objective)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["forgy", "kmeanspp", "kmeans_parallel",
                                  "coreset", "da_mssc"])
def test_baseline_fit_on_card_against_plain_twin(name):
    """``fit(method=name)`` on the card through the kernels against the
    same call with ``impl="ref"`` (same key, the torch backend): the
    full-data objective within 1e-3, A launched by every full-data Lloyd,
    B and C at the pool's k = 1 + 2k*5 by K-means||."""
    _card()
    from repro_torch import api
    from repro_torch.kernels import ops

    x, _ = blobs(40_000, 10, 28, seed=11)
    X = torch.from_numpy(x).cuda()
    cfg = api.BigMeansConfig(k=10, s=4_000, n_chunks=4, seed=5)
    ops.reset_launch_counts()
    res = api.fit(X, cfg, method=name)
    launches = ops.launch_counts()
    plain = api.fit(X, cfg.replace(impl="ref"), method=name)
    assert ops.launch_counts() == launches
    _, f = api.evaluate(res, X)
    _, f_plain = api.evaluate(plain, X)
    assert abs(f - f_plain) <= 1e-3 * f_plain
    assert res.algorithm == name and res.centroids.is_cuda
    counts = res.extras["counts"]
    if name in ("forgy", "kmeanspp", "kmeans_parallel"):
        assert counts.sum() == 40_000 and launches["fused_step"] > 0
    if name == "da_mssc":
        assert counts.sum() == res.n_chunks * cfg.s
    if name == "kmeans_parallel":
        assert launches["assign"] > 0 and launches["update"] > 0


@pytest.mark.cuda
def test_torch_categorical_on_card():
    """The inverse-CDF draw on the card: softmax(logits)'s distribution
    (chi-square over 8 categories, one of zero mass, below the 0.999
    quantile at 6 degrees of freedom) and a pure function of its key."""
    _card()
    from repro_torch import random as rnd

    p = np.array([0.3, 0.05, 0.0, 0.15, 0.2, 0.1, 0.12, 0.08])
    logits = torch.log(torch.tensor(p, dtype=torch.float32)).cuda()
    idx = rnd.TORCH.categorical(rnd.TORCH.key(2), logits, 200_000, "cuda")
    assert idx.is_cuda and torch.equal(
        idx, rnd.TORCH.categorical(rnd.TORCH.key(2), logits, 200_000, "cuda"))
    freq = np.bincount(idx.cpu().numpy(), minlength=8)
    expect = 200_000 * p[p > 0]
    assert freq[2] == 0
    assert float(np.sum((freq[p > 0] - expect) ** 2 / expect)) < 24.32


@pytest.mark.cuda
def test_baseline_autotune_times_the_chunk_shapes_only(_tuner):
    """``fit(method="forgy", autotune=True)`` tunes the chunk shapes as
    the reference's ``_pretune`` does and nothing at the baseline's own
    full-data shape (tuning is off while it runs), and is bitwise the
    untuned fit."""
    _card()
    from repro_torch import api

    x, _ = blobs(40_000, 10, 28, seed=12)
    X = torch.from_numpy(x).cuda()
    cfg = api.BigMeansConfig(k=10, s=4_000, n_chunks=4, seed=5)
    untuned = api.fit(X, cfg, method="forgy")
    was, n_timed = _tuner.enabled(), len(_tuner.timings())
    tuned = api.fit(X, cfg.replace(autotune=True), method="forgy")
    keys = {key for key, _, _ in _tuner.timings()[n_timed:]}
    assert keys and all("|m4000|" in key for key in keys)
    assert _tuner.enabled() == was
    assert torch.equal(tuned.centroids, untuned.centroids)


@pytest.mark.cuda
def test_suite_sequential_row_on_card_against_plain(tmp_path):
    """The reproduction suite's ``bm/sequential`` cell on ``hepmass-16k``,
    seed 0, through the kernels (``run_suite`` on the card) and again with
    ``impl="ref"`` on the card: both rows valid under the port's row
    schema, the first fit on ``'cuda'``, the two full-data objectives
    within RTOL."""
    _card()
    from repro_torch.evalsuite import datasets, schema, suite

    doc = suite.run_suite("quick", seeds=(0,), dataset_names=["hepmass-16k"],
                          method_names=["bm/sequential"],
                          data_root=str(tmp_path), verbose=False)
    assert schema.validate(doc, schema.SUITE_SCHEMA) == []
    assert doc["host"]["backend"] == "cuda"
    (row,) = doc["rows"]
    assert row["fit"]["impl"] == "cuda" and row["n_chunks"] == 24
    spec = datasets.get_dataset("hepmass-16k")
    plain = suite.MethodSpec("bm/sequential", "bigmeans", "sequential",
                             {"impl": "ref"})
    src = datasets.source(spec, str(tmp_path))
    twin = suite._run_cell(spec, plain, 0, src, src.as_array(), False)
    twin["epsilon"] = (twin["f_full"] - doc["datasets"][0]["f_star"]) / \
        doc["datasets"][0]["f_star"]
    twin["success"] = twin["epsilon"] <= doc["success_tol"]
    assert schema.validate(twin, schema._ROW_SCHEMA) == []
    assert twin["fit"]["impl"] == "ref" and twin["fit"]["device"] == "cuda"
    assert abs(row["f_full"] - twin["f_full"]) <= RTOL * twin["f_full"]


@pytest.fixture
def zoo_card():
    """The card with bf16 products accumulated in f32, as ``chip_smoke.py``
    phase 14 runs them; the cuBLAS switch is restored afterwards."""
    _card()
    mm = torch.backends.cuda.matmul
    was = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction = was


def _zoo_forward_twice(cfg, model, tokens, frames):
    from repro_torch.models import decode_check as dc

    a, _ = dc.forward(cfg, model, tokens, frames)
    b, _ = dc.forward(cfg, model, tokens, frames)
    assert tuple(a.shape) == (*tokens.shape, cfg.vocab_size)
    assert bool(torch.isfinite(a).all()) and torch.equal(a, b)


@pytest.mark.cuda
def test_zoo_hymba_on_card_forward_decode_and_embedding_fit(zoo_card):
    """``chip_smoke.py`` 14a at a small depth: hymba-1.5b at its published
    width with 2 layers, B = 2 x S = 512 (2 SSD chunks of 256): two
    forwards bitwise, prefill + 4 decoded tokens held as 14a holds them
    (``decode_check``), the harvested rows fitted by the kernels (A, B, C
    launched) to the plain twin's full-data objective within 1e-3."""
    import dataclasses

    from repro_torch import api
    from repro_torch.examples import embedding_clustering as ex
    from repro_torch.kernels import ops
    from repro_torch.models import decode_check as dc
    from repro_torch.models import registry, transformer

    cfg = dataclasses.replace(registry.get_config("hymba-1.5b"),
                              num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = transformer.init_params(cfg, gen)
    tokens, _ = dc.random_inputs(cfg, 2, 512, gen, torch.device("cuda"))
    _zoo_forward_twice(cfg, model, tokens, None)
    dec = dc.decode_gap(cfg, model, tokens, None, 4)
    assert dc.decode_faults(dec, hybrid=True) == []
    H = ex.harvest(cfg, model, tokens)
    assert tuple(H.shape) == (1024, 128) and H.is_cuda
    ops.reset_launch_counts()
    res = api.fit(H, k=64, s=512, n_chunks=5, seed=0)
    _, f = api.evaluate(res, H)
    counts = ops.launch_counts()
    assert counts["fused_step"] == res.n_iterations
    assert counts["update"] == 5 and counts["assign"] == 6
    twin = api.fit(H, k=64, s=512, n_chunks=5, seed=0, impl="ref")
    _, f_twin = api.evaluate(twin, H)
    assert abs(f - f_twin) <= 1e-3 * f_twin


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "deepseek-moe-16b",
                                  "qwen3-moe-235b-a22b"])
def test_zoo_others_on_card_forward_and_decode(arch, zoo_card):
    """``chip_smoke.py`` 14b at a small depth: the arch at its published
    width with 1 layer (seamless 1 + 1), B = 2 x S = 128: two forwards
    bitwise, prefill 124 + 4 decoded tokens with no token dropped
    (capacity_factor = E / top_k), held as 14b holds them."""
    import dataclasses

    from repro_torch.models import decode_check as dc
    from repro_torch.models import registry, transformer

    cfg = registry.get_config(arch)
    cfg = dataclasses.replace(
        cfg, num_layers=1, encoder_layers=min(cfg.encoder_layers, 1),
        capacity_factor=(cfg.num_experts / cfg.top_k if cfg.moe else 1.0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = transformer.init_params(cfg, gen)
    tokens, frames = dc.random_inputs(cfg, 2, 128, gen, torch.device("cuda"))
    _zoo_forward_twice(cfg, model, tokens, frames)
    dec = dc.decode_gap(cfg, model, tokens, frames, 4)
    assert dc.decode_faults(dec, hybrid=False) == []


def _train_batch(cfg, B, S, gen, device, frames=64):
    seq = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                        device=device)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    if cfg.family == "encdec":
        batch["frontend"] = torch.randn((B, frames, cfg.frontend_dim),
                                        generator=gen, device=device)
    return batch


@pytest.mark.cuda
def test_train_hymba_on_card_remat_determinism_and_nll(zoo_card):
    """``chip_smoke.py`` 15a at a small depth: hymba-1.5b at its published
    width with 2 layers, B = 2 x S = 512 (2 SSD chunks of 256): the loss
    bitwise the inference forward's NLL, "dots" bitwise "full", two runs
    of 3 AdamW steps bitwise, the loss falling, every gradient finite."""
    import dataclasses

    from repro_torch.models import flags, registry, transformer
    from repro_torch.train import optimizer, train_step

    cfg = dataclasses.replace(registry.get_config("hymba-1.5b"),
                              num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = _train_batch(cfg, 2, 512, gen, "cuda")

    def model():
        return transformer.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(1))

    m = model()
    logits, _ = transformer.forward(cfg, m, batch["tokens"])
    tot, cnt = transformer._nll(logits, batch["labels"])
    out = {}
    for policy in ("full", "dots"):
        flags.REMAT_POLICY = policy
        try:
            out[policy] = train_step.value_and_grad(cfg, m, batch)
        finally:
            flags.REMAT_POLICY = "full"
    assert torch.equal(out["full"][0], tot / cnt)
    assert torch.equal(out["full"][0], out["dots"][0])
    for k, g in out["full"][1].items():
        assert torch.isfinite(g).all(), k
        assert torch.equal(g, out["dots"][1][k]), k
    runs = []
    for _ in range(2):
        m = model()
        opt = optimizer.adamw(1e-3)
        state, step = opt.init(m), train_step.make_train_step(cfg, opt)
        losses = []
        for _ in range(3):
            m, state, met = step(m, state, batch)
            losses.append(met["loss"])
        runs.append((losses, m))
    assert float(runs[0][0][-1]) < float(runs[0][0][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1].parameters(),
                                                 runs[1][1].parameters()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "seamless-m4t-medium",
                                  "deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_train_step_reduced_on_card_matches_the_cpu(arch, zoo_card,
                                                    monkeypatch):
    """``chip_smoke.py`` 15b: one train step of the reduced config at f32
    compute on the card and on the CPU, from the same weights and batch:
    the loss within 1e-4, the new parameters within ``step_check``'s gap
    of the two steps' gradients."""
    import copy

    from repro_torch.models import layers, registry, transformer
    from repro_torch.train import optimizer, step_check, train_step

    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    cfg = registry.get_config(arch).reduced()
    cpu = transformer.init_params(cfg, 0, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    batch = _train_batch(cfg, 2, 32, torch.Generator().manual_seed(0), "cpu",
                         frames=16)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    p0 = {k: v.detach().clone() for k, v in cpu.named_parameters()}
    l_cpu, g_cpu = train_step.value_and_grad(cfg, cpu, batch)
    l_gpu, g_gpu = train_step.value_and_grad(cfg, gpu, gbatch)
    assert abs(l_gpu.item() - l_cpu.item()) <= 1e-4 * abs(l_cpu.item())
    opt = optimizer.adamw(1e-3)
    for m, b in ((cpu, batch), (gpu, gbatch)):
        train_step.make_train_step(cfg, opt)(m, opt.init(m), b)
    zeros = {k: torch.zeros_like(v) for k, v in p0.items()}
    bound = step_check.step_gap_bound(p0, g_cpu, g_gpu, zeros, zeros, 1,
                                      1e-3)
    for (k, v), w in zip(gpu.named_parameters(), cpu.parameters()):
        gap = (v.detach().cpu() - w.detach()).abs().double().numpy()
        assert (gap <= bound[k]).all(), k


@pytest.mark.cuda
def test_train_switches_on_card(zoo_card):
    """``chip_smoke.py`` 15c at a small depth: seamless (1 + 1 layers, its
    256,206 vocab) with ``CHUNKED_LOSS`` within 1e-5 of the unchunked loss;
    deepseek (1 layer) grouped into 4 at capacity E / top_k within 1e-6 of
    one group; hymba (1 layer) under ``BF16_GRADS``: the loss bitwise the
    f32-gradient one, only the tied embedding's gradient otherwise."""
    import dataclasses

    from repro_torch.models import flags, registry, transformer
    from repro_torch.train import train_step

    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = dataclasses.replace(registry.get_config("seamless-m4t-medium"),
                              num_layers=1, encoder_layers=1)
    m = transformer.init_params(cfg, gen)
    batch = _train_batch(cfg, 2, 256, gen, "cuda", frames=256)
    base = train_step.value_and_grad(cfg, m, batch)[0]
    flags.CHUNKED_LOSS = 64
    try:
        chunked = train_step.value_and_grad(cfg, m, batch)[0]
    finally:
        flags.CHUNKED_LOSS = None
    assert abs(chunked.item() - base.item()) <= 1e-5 * base.item()

    cfg = dataclasses.replace(registry.get_config("deepseek-moe-16b"),
                              num_layers=1)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    m = transformer.init_params(cfg, gen)
    batch = _train_batch(cfg, 4, 256, gen, "cuda")
    losses = []
    for groups in (0, 4):
        flags.MOE_GROUPED_DISPATCH = groups
        try:
            with torch.no_grad():
                losses.append(transformer.loss_fn(cfg, m, batch))
        finally:
            flags.MOE_GROUPED_DISPATCH = -1
    assert abs(losses[0].item() - losses[1].item()) <= 1e-6

    cfg = dataclasses.replace(registry.get_config("hymba-1.5b"), num_layers=1)
    m = transformer.init_params(cfg, gen)
    batch = _train_batch(cfg, 2, 256, gen, "cuda")
    l32, g32 = train_step.value_and_grad(cfg, m, batch)
    flags.BF16_GRADS = True
    try:
        l16, g16 = train_step.value_and_grad(cfg, m, batch)
    finally:
        flags.BF16_GRADS = False
    assert torch.equal(l16, l32)
    assert [k for k in g32 if not torch.equal(g16[k].float(), g32[k])] in (
        [], ["embedding"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-moe-16b"])
def test_dryrun_flops_equal_the_card_step(arch, zoo_card):
    """``chip_smoke.py`` 16b at a small depth: the dry run's count of a
    train step on a 1 x 1 fake mesh (``cuda`` device type) equals
    ``FlopCounterMode``'s count of the same step run on the card, exactly;
    its argument bytes are the f32 parameters and AdamW's two moments."""
    import dataclasses

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.models import registry, transformer
    from repro_torch.train import optimizer, train_step

    cfg = dataclasses.replace(registry.get_config(arch), num_layers=2)
    shape = ShapeSpec("t", "train", 512, 2)
    rec = dryrun.cell(cfg, shape, mesh_shape=((1, 1), ("data", "model")),
                      device_type="cuda")
    assert rec["status"] == "ok"
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = transformer.init_params(cfg, gen)
    batch = _train_batch(cfg, shape.global_batch, shape.seq_len, gen, "cuda")
    opt = optimizer.adamw(optimizer.warmup_cosine(3e-4, 2000, 100_000))
    step = train_step.make_train_step(cfg, opt)
    state = opt.init(model)
    with hlo_analysis.flop_counter() as counter:
        step(model, state, batch)
    torch.cuda.synchronize()
    assert rec["flops_per_device"] == counter.get_total_flops() > 0
    n = sum(p.numel() for p in model.parameters())
    tokens = 2 * 4 * shape.global_batch * shape.seq_len      # int32 pair
    assert rec["memory_analysis"]["argument_bytes"] == 12 * n + 4 + tokens


@pytest.mark.cuda
def test_dryrun_cluster_cell_runs_on_card():
    """``chip_smoke.py`` 16c at 16 worker positions (4 x 4, dealt onto the
    one card), 4 chunks a worker, ``max_iters`` 8: one A launch a Lloyd
    iteration, at most the cell's budget; the cell's model counts the
    exchange of each window."""
    from repro_torch.api import BigMeansConfig, TopologySpec, fit
    from repro_torch.data.synthetic import GMMSpec, gmm_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    _card()
    X = gmm_dataset(GMMSpec(m=16 * 4_000, n=27, components=25, seed=1),
                    device="cuda")
    cfg = BigMeansConfig(k=25, s=2_000, n_chunks=16 * 4, sync_every=2,
                         max_iters=dryrun.MAX_ITERS, seed=0,
                         topology=TopologySpec(kind="worker_mesh",
                                               devices=(4, 4),
                                               axes=("data", "model")))
    ops.reset_launch_counts()
    res = fit(X, cfg, method="sharded")
    launches = ops.launch_counts()
    assert res.extras["workers"] == 16
    assert launches["fused_step"] == res.n_iterations
    assert 0 < res.n_iterations <= dryrun.MAX_ITERS * cfg.n_chunks
    assert launches["update"] == launches["assign"] == cfg.n_chunks
    assert bool(torch.isfinite(res.centroids).all())
