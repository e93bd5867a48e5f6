"""The port's key-tree RNG interface, and a backend that replays jax.random.

:class:`JaxReplay` implements ``repro_torch.random``'s interface by calling
``jax.random`` on the CPU and handing the draws to torch, so the port's
trajectory can be held against the reference one decision at a time.  It
lives here, in the tests only; the other ``test_torch_*`` files import it.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch import random as rnd


class JaxReplay:
    """``repro_torch.random`` interface over ``jax.random`` (tests only)."""

    def key(self, seed):
        return jax.random.PRNGKey(seed)

    def split(self, key, n=2):
        return list(jax.random.split(key, n))

    def fold_in(self, key, data):
        return jax.random.fold_in(key, data)

    def randint(self, key, shape, lo, hi, device):
        idx = jax.random.randint(key, tuple(shape), lo, hi)
        return torch.from_numpy(np.array(idx)).to(device)

    def gumbel(self, key, shape, device):
        g = jax.random.gumbel(key, tuple(shape), dtype=np.float32)
        return torch.from_numpy(np.array(g)).to(device)

    def choice(self, key, n, size, device):
        idx = jax.random.choice(key, n, (size,), replace=False)
        return torch.from_numpy(np.array(idx)).to(device)

    def categorical(self, key, logits, size, device):
        logits = np.asarray(logits.detach().cpu().numpy(), np.float32)
        idx = jax.random.categorical(key, logits, shape=(size,))
        return torch.from_numpy(np.array(idx)).to(device)

    def key_to_array(self, key):
        """The jax key as it is: the reference's ``uint32[2]`` leaf."""
        return np.asarray(key, dtype=np.uint32)

    def key_from_array(self, a):
        return jax.numpy.asarray(np.asarray(a, dtype=np.uint32))


REPLAY = JaxReplay()


def test_gumbel_argmax_is_jax_categorical():
    """kmeanspp draws categorical(k, logits, shape=(L,)) as
    argmax(gumbel(k, (L, s)) + logits): exact, on the same key."""
    logits = np.log(np.random.default_rng(0).uniform(0.1, 9, 50)).astype(
        np.float32)
    for seed in range(5):
        k = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.categorical(k, logits, shape=(3,)))
        got = torch.argmax(REPLAY.gumbel(k, (3, 50), "cpu")
                           + torch.from_numpy(logits)[None], dim=1).numpy()
        np.testing.assert_array_equal(got, want)


def test_replay_split_matches_jax():
    k = REPLAY.key(7)
    a, b = REPLAY.split(k)
    ja, jb = jax.random.split(jax.random.PRNGKey(7))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(ja))
    np.testing.assert_array_equal(np.asarray(b), np.asarray(jb))


def test_replay_fold_in_matches_jax():
    """The streaming loop's per-chunk keys: ``fold_in(key, chunk_id)``."""
    k = REPLAY.key(5)
    for cid in (0, 1, 7, 31, 2**20):
        np.testing.assert_array_equal(
            np.asarray(REPLAY.fold_in(k, cid)),
            np.asarray(jax.random.fold_in(jax.random.PRNGKey(5), cid)))


def test_torch_rng_deterministic_and_distinct_children():
    r = rnd.TORCH
    k = r.key(3)
    assert r.split(k, 4) == r.split(k, 4)
    assert len(set(r.split(k, 64))) == 64
    assert r.split(k, 3) == [r.fold_in(k, i) for i in range(3)]
    a = r.randint(k, (100,), 0, 10, "cpu")
    b = r.randint(k, (100,), 0, 10, "cpu")
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 10
    g = r.gumbel(k, (4, 1000), "cpu")
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    # standard Gumbel: mean = Euler-Mascheroni 0.5772 (4000 draws: se ~0.02)
    assert abs(float(g.mean()) - 0.5772) < 0.1


@pytest.mark.parametrize("backend", [rnd.TORCH, REPLAY],
                         ids=["torch", "jax-replay"])
def test_key_codec_round_trips(backend):
    """A key survives the checkpoint's ``uint32[2]`` leaf: the same
    children after the round trip; TorchRNG stores ``[hi, lo]``."""
    for seed in (0, 1, 2**40 + 3):
        key = backend.key(seed)
        a = backend.key_to_array(key)
        assert a.dtype == np.uint32 and a.shape == (2,)
        back = backend.key_from_array(a)
        np.testing.assert_array_equal(np.asarray(backend.fold_in(back, 7)),
                                      np.asarray(backend.fold_in(key, 7)))
    key = rnd.TORCH.key(5)
    assert rnd.TORCH.key_from_array(rnd.TORCH.key_to_array(key)) == key
    np.testing.assert_array_equal(
        rnd.TORCH.key_to_array((1 << 63) | 2), [1 << 31, 2])


@pytest.mark.parametrize("backend", [rnd.TORCH, REPLAY],
                         ids=["torch", "jax-replay"])
def test_choice_without_replacement_unique(backend):
    idx = backend.choice(backend.key(11), 1000, 64, "cpu")
    assert len(np.unique(idx.numpy())) == 64
    assert int(idx.min()) >= 0 and int(idx.max()) < 1000
