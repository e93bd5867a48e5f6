"""The frozen copies under perfbench/gen held to the program's originals
at small sizes on the CPU: a drift shows here, and is not followed."""
import torch

from perfbench.gen import gmm, rng
from perfbench.gen import roofline as frozen
from perfbench.reference import judge
from repro_torch import random as prng
from repro_torch.core import bigmeans
from repro_torch.data import synthetic
from repro_torch.launch import roofline


def test_key_tree_is_the_programs():
    for seed in (0, 7, 2**31 + 5, 2**40 + 3):
        k = rng.key(seed)
        assert k == prng.TORCH.key(seed)
        assert rng.split(k, 5) == prng.TORCH.split(k, 5)
        assert rng.fold_in(k, 11) == prng.TORCH.fold_in(k, 11)
        assert torch.equal(rng.randint(k, (33,), 0, 1000, "cpu"),
                           prng.TORCH.randint(k, (33,), 0, 1000, "cpu"))


def test_generator_is_the_programs():
    for seed in (3, 2**33 + 1):
        spec = gmm.GMMSpec(m=70_000, n=5, components=4, seed=seed)
        ours = gmm.gmm_dataset(spec, device="cpu")
        theirs = synthetic.gmm_dataset(synthetic.GMMSpec(*spec),
                                       device="cpu")
        assert torch.equal(ours, theirs)
        means, probs = gmm.component_params(spec, "cpu")
        t_means, t_probs = synthetic._component_params(
            synthetic.GMMSpec(*spec), "cpu")
        assert torch.equal(means, t_means) and torch.equal(probs, t_probs)


def test_chunk_rows_are_the_sequential_fits_chunks():
    X = torch.arange(5000 * 2, dtype=torch.float32).reshape(5000, 2)
    seed, n_chunks, s = 2**35 + 9, 6, 300
    keys = prng.TORCH.split(prng.TORCH.key(seed), n_chunks)
    for i, key_i in enumerate(keys):
        ks, _ = prng.TORCH.split(key_i)
        chunk = bigmeans.sample_chunk(X, ks, s)
        rows = judge.chunk_rows(seed, i, m=5000, s=s, n_chunks=n_chunks,
                                device="cpu")
        assert torch.equal(X[rows], chunk)


def test_traffic_model_is_the_programs():
    for prec in ("f32", "bf16", "bf16x3", "int8"):
        assert frozen.chunk_bytes(64_000, 28, prec) == \
            roofline.chunk_bytes(64_000, 28, prec)
        assert frozen.chunk_traffic(16_384, 1024, 2048, prec, 6.5) == \
            roofline.chunk_traffic(16_384, 1024, 2048, prec, 6.5)
    assert frozen.HBM_BW == roofline.HBM_BW
    for prec, peak in roofline.PEAK_FLOPS.items():
        assert frozen.PEAK_FLOPS[prec] == peak
