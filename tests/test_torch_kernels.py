"""Parity of the port's kernel modules with the reference's.

The port's plain versions (what its ops run on the CPU) are held against
the reference's jnp oracles (``ops.*(impl="ref")``) and its Pallas kernels
in interpret mode, on the same numpy inputs.  Data are well-separated
mixtures, so ids and counts must be equal; sums, distances and objectives
differ only by summation order, and are held to bounds stated per test.

The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
holds each against its plain version on CUDA tensors, and
``test_torch_csrc.py`` checks their source logic on the CPU.
"""
import threading

import numpy as np
import pytest
import torch

from repro.kernels import fused_step as jfused
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.distance import assign_pallas
from repro.kernels.update import update_pallas
from repro_torch.kernels import distance, fused_step, kpp_probe, ops, ref, update
from repro_torch.kernels import precision as px
from test_torch_cuda import RTOL, blobs, d_bound, sums_bound

SHAPES = [  # (m, k, n): ragged m everywhere (tiles of 256 rows)
    (300, 25, 28),       # the main path's k and n
    (301, 130, 68),      # k > 128 (more than one lane tile), n = 68
    (257, 15, 3),        # n = 3
    (70, 1024, 1024),    # the fused envelope's edge
    (40, 1024, 1100),    # outside the envelope: the two-pass route
]
IDS = [f"m{m}-k{k}-n{n}" for m, k, n in SHAPES]


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_assign_matches_reference(shape):
    x, c = blobs(*shape)
    ids, d = ops.assign(t(x), t(c), impl="ref")
    ids, d = ids.numpy(), d.numpy()
    for name, (jids, jd) in {
        "ref": jops.assign(x, c, impl="ref"),
        "pallas_interpret": assign_pallas(x, c, interpret=True),
    }.items():
        np.testing.assert_array_equal(ids, np.asarray(jids), err_msg=name)
        assert np.all(np.abs(d - np.asarray(jd)) <= d_bound(x, c, ids)), name


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_update_matches_reference(shape):
    m, k, n = shape
    x, c = blobs(*shape)
    ids = np.asarray(jref.assign_ref(x, c)[0]).copy()
    ids[::7] = -1          # padding rows: never hit
    ids[3::11] = k         # out of range: adds nothing
    ids[5::13] = k + 40
    sums, counts = ops.update(t(x), t(ids), k, impl="ref")
    for name, (jsums, jcounts) in {
        "ref": jops.update(x, ids, k, impl="ref"),
        "pallas_interpret": update_pallas(x, ids, k, interpret=True),
    }.items():
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts),
                                      err_msg=name)
        err = np.abs(sums.numpy() - np.asarray(jsums))
        assert np.all(err <= sums_bound(x, ids, k)), name


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_fused_step_matches_reference(shape):
    m, k, n = shape
    x, c = blobs(*shape)
    assert fused_step.fits(k, n) == jfused.fits(k, n)
    sums, counts, obj = ops.fused_step(t(x), t(c), impl="ref")
    ids = np.asarray(jref.assign_ref(x, c)[0])
    refs = {"ref": jops.fused_step(x, c, impl="ref")}
    if jfused.fits(k, n):
        refs["pallas_interpret"] = jfused.fused_step_pallas(
            x, c, interpret=True)
    for name, (jsums, jcounts, jobj) in refs.items():
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts),
                                      err_msg=name)
        err = np.abs(sums.numpy() - np.asarray(jsums))
        assert np.all(err <= sums_bound(x, ids, k)), name
        # obj: a sum of m non-negative terms, well conditioned
        np.testing.assert_allclose(float(obj), float(jobj), rtol=RTOL,
                                   err_msg=name)


def test_pairwise_and_min_update_match_reference():
    x, c = blobs(257, 15, 28, seed=3)
    d = ref.pairwise_sqdist_ref(t(x), t(c)).numpy()
    jd = np.asarray(jref.pairwise_sqdist_ref(x, c))
    ids = np.argmin(jd, axis=1)
    bound = RTOL * (np.sqrt(np.sum(x.astype(np.float64) ** 2, 1))[:, None]
                    + np.sqrt(np.sum(c.astype(np.float64) ** 2, 1))[None]) ** 2
    assert np.all(np.abs(d - jd) <= bound)
    assert np.all(d >= 0)                          # the clamp at 0
    dmin = jd[np.arange(len(ids)), ids]
    got = ref.min_update_ref(t(dmin), t(x), t(c[4])).numpy()
    want = np.asarray(jref.min_update_ref(dmin, x, c[4]))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


def test_ref_chunked_matches_ref():
    x, c = blobs(1000, 25, 28, seed=4)
    ids, d = ops.assign(t(x), t(c), impl="ref")
    cids, cd = ops.assign(t(x), t(c), impl="ref_chunked", chunk=256)
    assert torch.equal(ids, cids)
    assert np.all(np.abs(d.numpy() - cd.numpy())
                  <= d_bound(x, c, ids.numpy()))


def test_fits_envelope_matches_reference():
    for k in (1, 25, 127, 128, 129, 256, 1000, 1024, 1025):
        for n in (1, 3, 28, 128, 129, 512, 900, 1024, 1025, 2048, 4096, 4097):
            assert fused_step.fits(k, n) == jfused.fits(k, n), (k, n)


def test_tally_holds_only_its_own_threads_launches():
    """``build.tally`` keeps what the wrappers note (``count_launch``) on
    its own thread inside the ``with``: nothing another thread notes
    meanwhile, nothing noted before or after it."""
    from repro_torch.kernels import build

    build.count_launch("assign")
    with build.tally() as mine:
        other = threading.Thread(target=lambda: [
            build.count_launch("update") for _ in range(1000)])
        other.start()
        for _ in range(3):
            build.count_launch("assign")
        other.join()
    build.count_launch("assign")
    assert mine == {"assign": 3}


def test_cpu_wrappers_take_the_plain_version():
    """A kernel wrapper never takes the plain version: on a CPU tensor it
    raises, and counts no launch.  Only ``ops`` runs the plain versions, for
    CPU tensors under the ref impls."""
    x, c = blobs(300, 25, 28, seed=5)
    xt, ct = t(x), t(c)
    ids, _ = distance.assign_plain(xt, ct)
    qx = px.quantize_chunk(xt)
    qb = px.quantize_chunk(xt[None])
    ops.reset_launch_counts()
    for call in (lambda: distance.assign_f32(xt, ct),
                 lambda: update.update_f32(xt, ids, 25),
                 lambda: fused_step.fused_step_f32(xt, ct),
                 lambda: fused_step.fused_step_batched_f32(xt[None],
                                                           ct[None]),
                 lambda: distance.assign_int8(qx, ct),
                 lambda: update.update_int8(qx, ids, 25),
                 lambda: fused_step.fused_step_int8(qx, ct),
                 lambda: fused_step.fused_step_batched_int8(qb, ct[None]),
                 *(call for p in ("bf16", "bf16x3") for call in (
                     lambda p=p: distance.assign_16(xt, ct, p),
                     lambda p=p: update.update_16(xt, ids, 25, p),
                     lambda p=p: fused_step.fused_step_16(xt, ct, p),
                     lambda p=p: fused_step.fused_step_batched_16(
                         xt[None], ct[None], p))),
                 lambda: fused_step.fused_step_f32(xt, ct, pipeline="dma"),
                 lambda: fused_step.fused_step_int8(qx, ct, pipeline="dma"),
                 *(lambda p=p: fused_step.fused_step_16(xt, ct, p,
                                                        pipeline="dma")
                   for p in ("bf16", "bf16x3")),
                 lambda: kpp_probe.kpp_probe_cuda(xt, ct[:3],
                                                  torch.ones(300)),
                 lambda: kpp_probe.SlotChain(xt, torch.ones(300), ct.clone(),
                                             3)):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            call()
    entry = ("fused_step", "assign", "update", "fused_step_batched",
             "fused_step_dma")
    assert ops.launch_counts() == dict.fromkeys(
        [e + p for p in ("", "_int8", "_bf16", "_bf16x3") for e in entry]
        + ["kpp_probe", "kpp_draw"], 0)
    sums, counts = ops.update(xt, ids, 25)
    assert all(torch.equal(a, b) for a, b in
               zip((sums, counts), update.update_plain(xt, ids, 25)))
    assert all(torch.equal(a, b) for a, b in
               zip(ops.fused_step(xt, ct), fused_step.fused_step_plain(xt, ct)))
