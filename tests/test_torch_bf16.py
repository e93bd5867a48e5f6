"""Parity of the port's bf16 and bf16x3 precision paths with the reference's.

Both packages get the same numpy inputs (made from a seed); the JAX side
runs its oracles (``impl="ref"``) and its Pallas kernels in interpret mode,
as the reference's own tests do.  Tolerances, per test:

* the policy helpers: storage casts bitwise (round-to-nearest-even on both
  sides); ``dot`` bitwise on bf16-exact small integers (every product and
  sum exact), elsewhere within 1e-6 of the sum of |products| (the same
  exact bf16 products, added in another order);
* oracles and the plain kernel versions against the reference's: ids
  identical off near-tie rows and counts equal; d, sums and objectives
  within ``RTOL`` (f32 norms and sums of the same values in another
  order);
* Lloyd and whole fits take the reference's decisions one by one through
  the jax-replay RNG backend: the same iterations, accept sequence,
  per-chunk Lloyd iterations and ``n_accepted``; objectives and centroids
  within ``RTOL``.

The reference's own ``tests/test_precision.py::
test_autotune_smoke_via_ops_interpret`` fails on the reference tree, run
alone on the CPU: it hands an f32 chunk to ``ops.fused_step`` at
``'bf16'``, and the Pallas kernel casts the chunk to bf16 before it takes
``||x||^2`` (``fused_step.py:330-332``) while the oracle takes ``||x||^2``
from the f32 values (``ref.py:50-51``); objectives 757.798 and 747.380, a
1.39 % gap where it allows 1 %.  ``test_f32_chunk_at_bf16_...`` pins that
finding: the port reproduces both sides, each against its own reference.
"""
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
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
from repro.kernels import precision as jpx
from repro.kernels import ref as jref
from repro.kernels.distance import assign_pallas
from repro.kernels.update import update_pallas
from repro_torch import api
from repro_torch.core import bigmeans, kmeans
from repro_torch.kernels import distance, fused_step, ops, ref, update
from repro_torch.kernels import precision as px
from test_torch_cuda import blobs
from test_torch_rng import REPLAY

jkpp = importlib.import_module("repro.core.kmeanspp")

RTOL = 1e-5   # f32 norms and sums of the same values in another order
POLICIES = ("bf16", "bf16x3")


def t(a):
    return torch.from_numpy(np.array(a))


def bits(a):
    """An array's bytes as unsigned integers: bitwise comparison."""
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def to_numpy(a):
    """A tensor (bf16 included) as numpy f32, for comparisons."""
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


def near_ties(x, c, precision):
    """Rows whose best two scores ||c||^2 - 2 dot(x, c) at the policy are
    within 1e-4 relative: there the argmin may go either way."""
    scores = px.sqnorm(c)[None, :] - 2.0 * px.dot(x, c, ([1], [1]),
                                                   precision)
    two = torch.topk(scores, 2, dim=1, largest=False).values
    return ((two[:, 1] - two[:, 0]) <= 1e-4 * two[:, 0].abs()).numpy()


# --------------------------------------------------------------------------
# the policy helpers
# --------------------------------------------------------------------------


DOT_CASES = [  # (a shape, b shape, contracted axes)
    ((300, 28), (25, 28), ([1], [1])),   # distances: x . c
    ((300, 25), (300, 28), ([0], [0])),  # update: onehot^T x
]


@pytest.mark.parametrize("data", ["integer", "normal"])
@pytest.mark.parametrize("precision", ("f32",) + POLICIES)
@pytest.mark.parametrize("case", DOT_CASES, ids=["distances", "update"])
def test_dot_matches_reference(case, precision, data):
    """``px.dot`` against ``repro.kernels.precision.dot``: bitwise on
    bf16-exact small integers; elsewhere within 1e-6 of sum |a||b|."""
    sa, sb, dims = case
    rng = np.random.default_rng(7)
    if data == "integer":
        a = rng.integers(-8, 9, size=sa).astype(np.float32)
        b = rng.integers(-8, 9, size=sb).astype(np.float32)
    else:
        a = (rng.normal(size=sa) * 3).astype(np.float32)
        b = (rng.normal(size=sb) * 3).astype(np.float32)
    jd = ((tuple(dims[0]), tuple(dims[1])), ((), ()))
    want = np.asarray(jpx.dot(jnp.asarray(a), jnp.asarray(b), jd, precision))
    got = px.dot(t(a), t(b), dims, precision).numpy()
    assert got.dtype == np.float32
    if data == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        cond = np.tensordot(np.abs(a), np.abs(b), axes=dims)
        assert np.all(np.abs(got - want) <= 1e-6 * cond)
    # bf16 operands arriving as bf16: the same contraction
    if precision != "f32":
        ab = torch.from_numpy(a).bfloat16()
        jab = jnp.asarray(a, jnp.bfloat16)
        want16 = np.asarray(jpx.dot(jab, jnp.asarray(b), jd, precision))
        got16 = px.dot(ab, t(b), dims, precision).numpy()
        cond = np.tensordot(np.abs(to_numpy(ab)), np.abs(b), axes=dims)
        assert np.all(np.abs(got16 - want16) <= 1e-6 * cond + 1e-6)


def test_bf16_policy_matches_reference():
    """storage_dtype, cast_storage (bitwise, ties to even), _split_bf16
    and resolve('auto', bf16) against the reference's."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(200, 9)) * 100).astype(np.float32)
    # values halfway between two bf16 numbers: ties decide to even
    x[0] = (np.float32(1.0) + np.float32(2.0 ** -8)
            * np.arange(1, 18, 2)[:9]).astype(np.float32)
    assert px.storage_dtype("bf16") == torch.bfloat16
    assert px.storage_dtype("bf16x3") == torch.float32
    assert jpx.storage_dtype("bf16") == jnp.bfloat16
    for prec in POLICIES:
        got = px.cast_storage(t(x), prec)
        want = jpx.cast_storage(jnp.asarray(x), prec)
        assert got.dtype == px.storage_dtype(prec)
        if prec == "bf16":
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy().view(np.uint16),
                np.asarray(want).view(np.uint16))
        else:
            np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    hi, lo = px._split_bf16(t(x))
    jhi, jlo = jpx._split_bf16(jnp.asarray(x))
    np.testing.assert_array_equal(bits(hi.numpy()),
                                  bits(np.asarray(jhi, np.float32)))
    np.testing.assert_array_equal(bits(lo.numpy()),
                                  bits(np.asarray(jlo, np.float32)))
    xb = t(x).bfloat16()
    assert px.resolve("auto", torch.bfloat16) == "bf16" \
        == jpx.resolve("auto", jnp.bfloat16)
    assert px.resolve(None, torch.bfloat16) == "bf16"
    assert px.resolve("bf16x3", torch.bfloat16) == "bf16x3"
    assert px.cast_storage(xb, "auto") is xb            # already stored
    assert px.cast_storage(xb, "bf16x3").dtype == torch.float32
    assert ops.resolve_precision("auto", xb) == "bf16"


# --------------------------------------------------------------------------
# the oracles and the plain kernel versions
# --------------------------------------------------------------------------


ORACLE_CASES = [  # (m, k, n)
    (500, 25, 28),
    (301, 130, 68),
    (257, 5, 3),
]


@pytest.mark.parametrize("stored", [False, True], ids=["f32-in", "bf16-in"])
@pytest.mark.parametrize("precision", POLICIES)
@pytest.mark.parametrize("case", ORACLE_CASES,
                         ids=[f"m{m}-k{k}-n{n}" for m, k, n in ORACLE_CASES])
def test_oracles_match_reference(case, precision, stored):
    """pairwise_sqdist_ref, assign_ref, update_ref and ops' two-pass step
    under the policy against ``repro.kernels.ref`` / ``ops.fused_step(
    impl="ref")``, on an f32 chunk and on the chunk stored bf16."""
    m, k, n = case
    x, c = blobs(m, k, n, seed=m + k)
    X = t(x).bfloat16() if stored else t(x)
    jx = jnp.asarray(x, jnp.bfloat16) if stored else jnp.asarray(x)
    C = t(c)
    ties = near_ties(X, C, precision)
    assert ties.sum() <= 2

    d = ref.pairwise_sqdist_ref(X, C, precision=precision).numpy()
    jd = np.asarray(jref.pairwise_sqdist_ref(jx, c, precision=precision))
    scale = (np.sqrt((to_numpy(X).astype(np.float64) ** 2).sum(1))[:, None]
             + np.sqrt((c.astype(np.float64) ** 2).sum(1))[None]) ** 2
    assert np.all(np.abs(d - jd) <= RTOL * scale)

    ids, dd = ref.assign_ref(X, C, precision=precision)
    jids, jdd = jref.assign_ref(jx, c, precision=precision)
    np.testing.assert_array_equal(ids.numpy()[~ties], np.asarray(jids)[~ties])
    rows = np.arange(m)
    assert np.all(np.abs(dd.numpy() - np.asarray(jdd))
                  <= RTOL * scale[rows, np.asarray(jids)])

    uids = np.asarray(jids).copy()
    uids[::7] = -1                      # padding rows: never hit
    uids[3::11] = k                     # out of range: adds nothing
    sums, counts = ref.update_ref(X, t(uids), k, precision=precision)
    jsums, jcounts = jref.update_ref(jx, uids, k, precision=precision)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    abs_s, _ = ref.update_ref(t(np.abs(to_numpy(X))), t(uids), k)
    assert np.all(np.abs(sums.numpy() - np.asarray(jsums))
                  <= RTOL * abs_s.numpy() + 1e-6)

    fs = ops.fused_step(X, C, impl="ref", precision=precision)
    jfs = jops.fused_step(jx, c, impl="ref", precision=precision)
    np.testing.assert_array_equal(fs[1].numpy(), np.asarray(jfs[1]))
    np.testing.assert_allclose(float(fs[2]), float(jfs[2]), rtol=RTOL)
    if stored:      # on stored data the oracle is the plain kernel version
        plain = fused_step.fused_step_plain(X, C, precision)
        assert all(torch.equal(a, b) for a, b in zip(fs, plain))


PALLAS_CASES = [  # (m, k, n, block_m)
    (300, 25, 28, 256),
    (257, 25, 3, 128),
    (300, 129, 40, 256),
]


@pytest.mark.parametrize("precision", POLICIES)
@pytest.mark.parametrize("case", PALLAS_CASES, ids=[
    f"m{m}-k{k}-n{n}-bm{b}" for m, k, n, b in PALLAS_CASES])
def test_plain_kernels_match_interpreted_pallas(case, precision):
    """The port's plain versions of A16/A3, B16/B3 and C16/C3 (x cast to
    storage first) against ``fused_step_pallas``, ``assign_pallas`` and
    ``update_pallas`` at the policy in interpret mode, on an f32 chunk:
    counts and ids equal off near ties; sums, d and obj within RTOL."""
    m, k, n, block_m = case
    x, c = blobs(m, k, n, seed=2 * m + k)
    X, C = t(x), t(c)
    ties = near_ties(px.cast_storage(X, precision), C, precision)
    assert ties.sum() <= 2
    xs = to_numpy(px.cast_storage(X, precision))

    js, jn, jo = jfused.fused_step_pallas(x, c, precision=precision,
                                          block_m=block_m, interpret=True)
    sums, counts, obj = fused_step.fused_step_plain(X, C, precision)
    ids_p, _ = distance.assign_plain(X, C, precision)
    abs_s, _ = ref.update_ref(t(np.abs(xs)), ids_p, k)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jn))
    assert np.all(np.abs(sums.numpy() - np.asarray(js))
                  <= RTOL * abs_s.numpy() + 1e-6)
    np.testing.assert_allclose(float(obj), float(jo), rtol=RTOL)

    jids, jd = assign_pallas(x, c, precision=precision, block_m=block_m,
                             interpret=True)
    ids, d = distance.assign_plain(X, C, precision)
    np.testing.assert_array_equal(ids.numpy()[~ties], np.asarray(jids)[~ties])
    scale = (np.sqrt((xs.astype(np.float64) ** 2).sum(1))
             + np.sqrt((c.astype(np.float64) ** 2).sum(1))[ids.numpy()]) ** 2
    assert np.all(np.abs(d.numpy() - np.asarray(jd)) <= RTOL * scale)

    uids = np.asarray(jids).copy()
    uids[::5] = -1                      # padding rows: never hit
    jus, juc = update_pallas(x, uids, k, precision=precision,
                             block_m=block_m, interpret=True)
    us, uc = update.update_plain(X, t(uids), k, precision)
    abs_u, _ = ref.update_ref(t(np.abs(xs)), t(uids), k)
    np.testing.assert_array_equal(uc.numpy(), np.asarray(juc))
    assert np.all(np.abs(us.numpy() - np.asarray(jus))
                  <= RTOL * abs_u.numpy() + 1e-6)


@pytest.mark.parametrize("precision", POLICIES)
def test_plain_batched_step_matches_interpreted_pallas(precision):
    """The plain version of D16 / D3 against ``fused_step_batched_pallas``
    at the policy in interpret mode (counts equal, sums and obj within
    RTOL); each stream is the single-stream plain step on it, bit for bit,
    and ops' batched ref route is the reference's batched oracle."""
    pairs = [blobs(300, 25, 28, seed=20 + b) for b in range(3)]
    x = np.stack([p[0] for p in pairs])
    c = np.stack([p[1] for p in pairs])
    js, jn, jo = jfused.fused_step_batched_pallas(x, c, precision=precision,
                                                  interpret=True)
    sums, counts, obj = fused_step.fused_step_batched_plain(t(x), t(c),
                                                            precision)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jn))
    np.testing.assert_allclose(obj.numpy(), np.asarray(jo), rtol=RTOL)
    for b in range(3):
        xs = to_numpy(px.cast_storage(t(x[b]), precision))
        ids_p, _ = distance.assign_plain(t(x[b]), t(c[b]), precision)
        abs_s, _ = ref.update_ref(t(np.abs(xs)), ids_p, 25)
        assert np.all(np.abs(sums[b].numpy() - np.asarray(js[b]))
                      <= RTOL * abs_s.numpy() + 1e-6)
        one = fused_step.fused_step_plain(t(x[b]), t(c[b]), precision)
        assert all(torch.equal(g[b], o)
                   for g, o in zip((sums, counts, obj), one))
    got = ops.fused_step_batched(t(x), t(c), impl="ref", precision=precision)
    want = jops.fused_step_batched(x, c, impl="ref", precision=precision)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=RTOL)


def test_f32_chunk_at_bf16_pins_the_storage_norm_finding():
    """The reference's failing ``test_autotune_smoke_via_ops_interpret``,
    explained.  On an f32 chunk at ``'bf16'`` the Pallas kernel casts x to
    bf16 before it takes ``||x||^2``; the oracle rounds x to bf16 only in
    the dot and takes ``||x||^2`` from the f32 values.  Same counts, but
    objectives ~1 % apart: the rounding of ``||x||^2`` does not cancel in
    ``||x||^2 - 2 x.c + ||c||^2``, whose value is small beside its terms.
    The port keeps both semantics apart, as the reference does: its plain
    kernel version (what kernels A16 / B16 / C16 compute) matches the
    Pallas kernel, and its ``ops.fused_step(impl="ref")`` matches the
    reference's oracle, each within RTOL.  On the chunk stored bf16, as
    ``lloyd`` passes it, the two agree."""
    kx, kc = jax.random.split(jax.random.PRNGKey(0))
    centers = jax.random.normal(kc, (25, 28)) * 4.0
    lab = jax.random.randint(jax.random.PRNGKey(1), (300,), 0, 25)
    x = np.asarray(centers[lab] + jax.random.normal(kx, (300, 28)) * 0.3)
    c = np.asarray(centers + 0.05)

    js, jn, jo = jfused.fused_step_pallas(x, c, precision="bf16",
                                          interpret=True)
    ps, pn, po = fused_step.fused_step_plain(t(x), t(c), "bf16")
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=RTOL,
                               atol=RTOL * float(np.abs(js).max()))
    np.testing.assert_allclose(float(po), float(jo), rtol=RTOL)

    rs, rn, ro = jops.fused_step(x, c, impl="ref", precision="bf16")
    os_, on, oo = ops.fused_step(t(x), t(c), impl="ref", precision="bf16")
    np.testing.assert_array_equal(on.numpy(), np.asarray(rn))
    np.testing.assert_allclose(float(oo), float(ro), rtol=RTOL)

    gap = abs(float(po) - float(oo)) / float(oo)
    assert gap > 0.01, gap                          # 757.80 against 747.38
    np.testing.assert_array_equal(pn.numpy(), on.numpy())
    stored = ops.fused_step(t(x).bfloat16(), t(c), impl="ref",
                            precision="bf16")
    np.testing.assert_allclose(float(stored[2]), float(po), rtol=RTOL)


# --------------------------------------------------------------------------
# Lloyd and whole fits
# --------------------------------------------------------------------------


DATA = {n: np.asarray(gmm_dataset(GMMSpec(m=4096, n=n, components=15,
                                          seed=2)))
        for n in (3, 28)}


@pytest.mark.parametrize("precision", POLICIES)
@pytest.mark.parametrize("n", [3, 28])
def test_lloyd_matches_reference(n, precision):
    """``lloyd`` and ``lloyd_batched`` at the policy against the
    reference's (``impl="ref"``): the same iterations, assignments and
    counts; centroids and the objective within RTOL; the batched streams
    each equal to a single-stream port ``lloyd`` bit for bit."""
    X = DATA[n]
    s, k, B = 1000, 15, 3
    pts = np.stack([X[i * s:(i + 1) * s] for i in range(B)])
    init = np.stack([np.asarray(jkpp.kmeanspp(pts[i],
                                              jax.random.PRNGKey(i), k))
                     for i in range(B)])
    want = jkm.lloyd(pts[0], init[0], impl="ref", precision=precision)
    got = kmeans.lloyd(t(pts[0]), t(init[0]), impl="ref",
                       precision=precision)
    assert got.iterations == int(want.iterations)
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(want.assignments))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    scale = float(np.abs(np.asarray(want.centroids)).max())
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=RTOL)

    wantb = jkm.lloyd_batched(pts, init, impl="ref", precision=precision)
    gotb = kmeans.lloyd_batched(t(pts), t(init), impl="ref",
                                precision=precision)
    np.testing.assert_array_equal(gotb.iterations.numpy(),
                                  np.asarray(wantb.iterations))
    for field in ("assignments", "counts", "degenerate"):
        np.testing.assert_array_equal(getattr(gotb, field).numpy(),
                                      np.asarray(getattr(wantb, field)),
                                      err_msg=field)
    np.testing.assert_allclose(gotb.objective.numpy(),
                               np.asarray(wantb.objective), rtol=RTOL)
    np.testing.assert_allclose(gotb.centroids.numpy(),
                               np.asarray(wantb.centroids), rtol=RTOL,
                               atol=RTOL * scale)
    assert torch.equal(gotb.centroids[0], got.centroids)
    assert torch.equal(gotb.objective[0], got.objective)


SLOW_CHUNK = Path(__file__).parent / "data" / "bf16_slow_chunk.npz"


def test_bf16_lloyd_matches_reference_on_a_slow_card_chunk():
    """A chunk on which bf16 Lloyd runs long: stream 1 of round 0 of the
    batched bf16 HEPMASS-size fit on the card (seed 0), captured with its
    initial centroids by ``tools/int8_slow_chunk.py --precision bf16``
    (the bf16 values' 16 bits as two byte planes).  On the card the port
    took 16 iterations there, through the kernels and the plain path, where
    f32 Lloyd from the same start stops after 4: the bf16 loop objective
    wanders by 2e-4 to 2e-3 relative between iterations, above the 1e-4
    tolerance (bf16 products of the centroids).  This is the bf16 scheme,
    not the port: the reference's ``lloyd(precision="bf16")`` takes the
    same 16 iterations on the chunk, jitted and op by op, single and
    batched (B = 1).

    Tolerances: the same iterations; assignments and counts equal to the
    reference's; centroids and the objective within RTOL (f32 sums in
    another order); the batched port bitwise the single one."""
    z = np.load(SLOW_CHUNK)
    bits = ((z["hi"].astype(np.uint16) << 8) | z["lo"]).view(np.int16)
    xt = torch.from_numpy(bits).view(torch.bfloat16)
    xj = jnp.asarray(bits).view(jnp.bfloat16)
    init = z["init"]
    got = kmeans.lloyd(xt, t(init), impl="ref", precision="bf16")
    got_b = kmeans.lloyd_batched(xt[None], t(init)[None], impl="ref",
                                 precision="bf16")
    want = jkm.lloyd(xj, init, impl="ref", precision="bf16")
    want_b = jkm.lloyd_batched(xj[None], init[None], impl="ref",
                               precision="bf16")
    with jax.disable_jit():
        eager = jkm.lloyd(xj, init, impl="ref", precision="bf16")
    assert got.iterations == int(want.iterations) == int(eager.iterations)
    assert got.iterations == 16
    assert int(got_b.iterations[0]) == int(want_b.iterations[0]) == 16
    scale = float(np.abs(init).max())
    for ref_run in (want, eager):
        np.testing.assert_array_equal(got.assignments.numpy(),
                                      np.asarray(ref_run.assignments))
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(ref_run.counts))
        np.testing.assert_allclose(got.centroids.numpy(),
                                   np.asarray(ref_run.centroids), rtol=RTOL,
                                   atol=RTOL * scale)
        np.testing.assert_allclose(float(got.objective),
                                   float(ref_run.objective), rtol=RTOL)
    assert torch.equal(got_b.centroids[0], got.centroids)
    assert torch.equal(got_b.objective[0], got.objective)


def test_seed_keeps_a_bf16_chunk():
    """K-means++ on a bf16 chunk contracts in bf16, as the reference's
    ``seed`` does (``kmeanspp.py:55-56``): through the jax-replay key tree
    the port picks the reference's seeds, centroids equal (they are rows
    of the bf16 chunk, widened)."""
    from repro_torch.core import kmeanspp

    x = DATA[28][:2000]
    xb = t(x).bfloat16()
    got = kmeanspp.seed(xb, REPLAY.key(5), 15, rng=REPLAY)
    want = jkpp.seed(jnp.asarray(x, jnp.bfloat16), jax.random.PRNGKey(5), 15)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


FITS = {"sequential": dict(),
        "batched-sync1": dict(batch=4, sync_every=1),
        "batched-sync2": dict(batch=4, sync_every=2)}


@pytest.fixture(scope="module", params=("road3d-24k", "hepmass-16k"))
def dataset(request):
    spec = get_dataset(request.param)
    return spec, np.asarray(gmm_dataset(spec.gmm))


@pytest.mark.parametrize("precision", POLICIES)
@pytest.mark.parametrize("fit_kind", FITS)
def test_fit_matches_reference(dataset, fit_kind, precision):
    """``fit(..., precision=..., device="cpu")`` against
    ``repro.api.fit(..., impl="ref", precision=...)`` with the reduced
    chunk budget of the reference's precision tests (8 chunks), through the
    jax-replay RNG: the same accept sequence, per-chunk Lloyd iterations,
    ``n_accepted`` and ``n_dist_evals``; objectives and centroids within
    RTOL."""
    spec, X = dataset
    cfg = dict(k=spec.k, s=spec.s, n_chunks=8, **FITS[fit_kind])
    want = japi.fit(X, japi.BigMeansConfig(**cfg), impl="ref",
                    precision=precision)
    got = api.fit(X, api.BigMeansConfig(**cfg), device="cpu", rng=REPLAY,
                  precision=precision)
    assert got.strategy == want.strategy
    assert got.extras["fit"]["precision"] == precision
    assert [a for *_, a in got.trace] == [a for *_, a in want.trace]
    assert got.n_accepted == want.n_accepted
    assert got.n_iterations == want.n_iterations
    np.testing.assert_allclose(got.n_dist_evals, want.n_dist_evals,
                               rtol=1e-6)
    np.testing.assert_allclose([f for _, f, _ in got.trace],
                               [f for _, f, _ in want.trace], rtol=RTOL)
    ref_c = np.asarray(want.centroids)
    np.testing.assert_allclose(got.centroids.numpy(), ref_c, rtol=RTOL,
                               atol=RTOL * float(np.abs(ref_c).max()))

    # per chunk: Lloyd iterations, accepts and degenerate counts
    key = dict(k=spec.k, s=spec.s)
    if fit_kind == "sequential":
        kw = dict(key, n_chunks=8)
        _, jinfos = jbm.big_means(X, jax.random.PRNGKey(0), impl="ref",
                                  precision=precision, **kw)
        _, infos = bigmeans.big_means(X, REPLAY.key(0), rng=REPLAY,
                                      device="cpu", precision=precision,
                                      **kw)
    else:
        kw = dict(key, batch=4, rounds=2,
                  sync_every=FITS[fit_kind]["sync_every"])
        _, jinfos = jbm.big_means_batched(X, jax.random.PRNGKey(0),
                                          impl="ref", precision=precision,
                                          **kw)
        _, infos = bigmeans.big_means_batched(
            X, REPLAY.key(0), rng=REPLAY, device="cpu", precision=precision,
            **kw)
    for field in ("lloyd_iters", "accepted", "n_degenerate"):
        np.testing.assert_array_equal(getattr(infos, field).numpy(),
                                      np.asarray(getattr(jinfos, field)),
                                      err_msg=field)
