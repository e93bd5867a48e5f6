"""The K-means++ candidate probe (kernel P's plain version) against the
reference's ``kpp_probe_pallas``, run in interpret mode, and its oracle.

Inputs are made by numpy from a seed and handed to both packages.  The
kernel itself runs only on the card (``test_torch_cuda.py``); its source
logic is held to ``kpp_probe_plain`` by the host stand-in
(``test_torch_csrc.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kpp_probe as jkpp
from repro.kernels import ref as jref
from repro_torch.kernels import kpp_probe as kpp
from repro_torch.kernels import ref

# The reference test's shapes (tests/test_fused_kernel.py:70-71).
SHAPES = [(100, 7, 3), (513, 28, 3), (300, 768, 8), (1000, 68, 128)]


def probe_inputs(m, n, L, seed=2):
    """x [m,n] and cands [L,n] standard normal, d [m] uniform in [0, 5):
    the distributions of the reference's test, from numpy."""
    rng = np.random.default_rng(seed + m + n + L)
    x = rng.normal(size=(m, n)).astype(np.float32)
    cands = rng.normal(size=(L, n)).astype(np.float32)
    d = (rng.uniform(size=m) * 5.0).astype(np.float32)
    return x, cands, d


@pytest.mark.parametrize("m,n,L", SHAPES)
def test_plain_matches_interpreted_pallas(m, n, L):
    """``kpp_probe_plain`` against ``kpp_probe_pallas(interpret=True)``.

    Tolerances: newd allclose at rtol 1e-5 and atol 1e-4, pot at rtol
    1e-5.  Both associate ``(csq - 2 dot) + xsq``, but XLA's CPU dot and
    norm reductions add the features in another order than torch's, so
    newd differs by a few ulps of the terms (|csq|, |2 dot|, |xsq| up to
    ~2n), which the absolute part covers where newd is small.
    """
    x, cands, d = probe_inputs(m, n, L)
    newd_j, pot_j = jkpp.kpp_probe_pallas(jnp.asarray(x), jnp.asarray(cands),
                                          jnp.asarray(d), interpret=True)
    newd, pot = kpp.kpp_probe_plain(torch.from_numpy(x),
                                    torch.from_numpy(cands),
                                    torch.from_numpy(d))
    assert newd.shape == (m, L) and pot.shape == (L,)
    assert newd.dtype == torch.float32 and pot.dtype == torch.float32
    np.testing.assert_allclose(newd.numpy(), np.asarray(newd_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(pot.numpy(), np.asarray(pot_j), rtol=1e-5)


@pytest.mark.parametrize("m,n,L", SHAPES)
def test_plain_matches_oracle(m, n, L):
    """Against ``min(d, pairwise_sqdist_ref(x, cands))`` (the reference's
    and the port's oracle) at the reference test's own tolerance (rtol
    2e-4, atol 1e-3 for newd; rtol 2e-4, atol 1e-2 for pot): the oracle
    associates ``x2 - 2 dots + c2``."""
    x, cands, d = probe_inputs(m, n, L)
    newd, pot = kpp.kpp_probe_plain(torch.from_numpy(x),
                                    torch.from_numpy(cands),
                                    torch.from_numpy(d))
    want_j = np.minimum(d[:, None], np.asarray(jref.pairwise_sqdist_ref(
        jnp.asarray(x), jnp.asarray(cands))))
    want = torch.minimum(torch.from_numpy(d)[:, None],
                         ref.pairwise_sqdist_ref(torch.from_numpy(x),
                                                 torch.from_numpy(cands)))
    for oracle in (want_j, want.numpy()):
        np.testing.assert_allclose(newd.numpy(), oracle, rtol=2e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(pot.numpy(), oracle.sum(0), rtol=2e-4,
                                   atol=1e-2)


def test_fits_matches_reference():
    for L in (1, 3, 127, 128, 129, 256):
        for n in (1, 28, 1023, 1024, 1025, 4096):
            assert kpp.fits(L, n) == jkpp.fits(L, n), (L, n)


def test_cpu_runs_the_plain_version_and_the_kernel_refuses_it():
    """``kpp_probe`` takes the plain version for CPU tensors (and casts
    bf16 points to f32, as the reference's wrapper does); the kernel's
    wrapper raises on CPU tensors and outside the envelope, and counts no
    launch."""
    x, cands, d = probe_inputs(513, 28, 3)
    X, C, D = torch.from_numpy(x), torch.from_numpy(cands), torch.from_numpy(d)
    got = kpp.kpp_probe(X, C, D)
    want = kpp.kpp_probe_plain(X, C, D)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got16 = kpp.kpp_probe(X.bfloat16(), C, D)
    want16 = kpp.kpp_probe_plain(X.bfloat16().float(), C, D)
    assert all(torch.equal(a, b) for a, b in zip(got16, want16))
    before = kpp.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kpp.kpp_probe_cuda(X, C, D)
    with pytest.raises(ValueError, match="L <= 128"):
        kpp.kpp_probe_cuda(X, torch.zeros(129, 28), D)
    with pytest.raises(ValueError, match="n <= 1024"):
        kpp.kpp_probe_cuda(torch.zeros(4, 1025), torch.zeros(3, 1025),
                           torch.zeros(4))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        kpp.kpp_probe(X, C, D, impl="cuda")
    assert kpp.launches == before


class PlainSlotChain:
    """:class:`kpp.SlotChain` with kernels G and P replaced by their plain
    versions (``kpp_draw_plain``, ``kpp_probe_plain``), in the order and
    with the pending pick of the kernels."""

    def __init__(self, x, d, c, L):
        self.x, self.d, self.c, self.pending = x, d, c, None

    def _pick(self):
        b = int(torch.argmin(self.pot))
        self.c[self.pending] = self.cands[b]
        return b

    def slot(self, noise, j):
        if self.pending is not None:
            self.d.copy_(self.newd[:, self._pick()])
        _, self.cands = kpp.kpp_draw_plain(self.x, noise, self.d)
        self.newd, self.pot = kpp.kpp_probe_plain(self.x, self.cands, self.d)
        self.pending = j

    def finish(self):
        if self.pending is not None:
            self._pick()


@pytest.mark.parametrize("n", [3, 28])
def test_seed_through_the_slot_chain_on_exact_data(n, monkeypatch):
    """``seed`` where the slot kernels apply (``resolve_impl`` made to say
    ``'cuda'``; the chain's kernels replaced by their plain versions) on
    integer points, where every distance and potential is exact in f32 in
    either association: bitwise the reference's seeding under the replayed
    keys, fresh and re-seeding, and bitwise the oracle chain
    (``impl="ref"``) under the port's keys; each seeded slot counted as
    ``probe.kernel``."""
    import importlib

    import jax

    from repro_torch import tracing
    from repro_torch.core import kmeanspp
    from repro_torch.kernels import ops
    from test_torch_rng import REPLAY

    # the module (repro.core re-exports the function under its name)
    jkmeanspp = importlib.import_module("repro.core.kmeanspp")

    X = np.random.default_rng(n).integers(0, 3, size=(2048, n)).astype(
        np.float32)
    key = jax.random.PRNGKey(4 + n)
    deg = np.zeros(15, bool)
    deg[[0, 6, 14]] = True
    want = np.asarray(jkmeanspp.seed(X, key, 15))
    want2 = np.asarray(jkmeanspp.seed(X, key, 15, init=want, degenerate=deg))
    plain = kmeanspp.seed(torch.from_numpy(X), 5, 15, impl="ref")
    monkeypatch.setattr(ops, "resolve_impl", lambda impl, device: "cuda")
    monkeypatch.setattr(kpp, "SlotChain", PlainSlotChain)
    tracing.snapshot()
    tracing.enable(True)
    try:
        got = kmeanspp.seed(torch.from_numpy(X), key, 15, rng=REPLAY)
        got2 = kmeanspp.seed(torch.from_numpy(X), key, 15, init=got,
                             degenerate=torch.from_numpy(deg), rng=REPLAY)
        ours = kmeanspp.seed(torch.from_numpy(X), 5, 15)
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.enable(False)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got2.numpy(), want2)
    assert torch.equal(ours, plain)
    assert counters == {"core.kmeanspp.probe.kernel": 15 + 3 + 15,
                        "host_sync.core.kmeanspp.mask": 1}
