"""The zoo's two entry points in the port — the embedding-clustering example
(``repro_torch.examples.embedding_clustering``) and the clustering launcher
(``repro_torch.launch.train``) — held to the reference's on the CPU, and
the MoE combine's determinism."""
import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
from repro.data import synthetic as jsyn
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.registry import LM_ARCHS
from repro.models.registry import get_config as jget
from repro_torch import convert
from repro_torch.examples import embedding_clustering as pex
from repro_torch.launch import train as ptrain
from repro_torch.models import layers as PL
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as PT
from repro_torch.models.registry import get_config as pget
from test_torch_rng import REPLAY

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5       # f32 objectives summed in another order
F32_RTOL = 1e-4   # as test_torch_models.py: f32 compute in both packages
BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The products here are small: two torch threads keep the suite's
    parallel workers from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _reference_example():
    """The reference's ``examples/embedding_clustering.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "reference_embedding_clustering",
        ROOT / "examples" / "embedding_clustering.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_H(cfg, params, tokens, frames):
    """The reference example's harvest, as it computes it inline."""
    from repro.models.registry import model_fns

    mod = model_fns(cfg)
    if cfg.family == "encdec":
        logits, _ = mod.forward(cfg, params, tokens, frames)
    else:
        logits, _ = mod.forward(cfg, params, tokens)
    H = logits.reshape(-1, logits.shape[-1]).astype(jnp.float32)
    return np.asarray(H[:, :128] if H.shape[1] > 128 else H)


# ------------------------------------------------ embedding clustering

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_harvest_matches_the_reference(arch, monkeypatch):
    """The example's harvest on the reference's weights and tokens, at f32
    compute in both packages, the reference's B, S = 16, 64: within
    F32_RTOL of the rows' scale.  hymba's SSD keeps its hard-coded bf16
    casts: where an f32 value that differs in its last bits rounds to the
    other bf16 neighbour, the rows after it move by a fraction of a bf16
    step (0.34 of one at most over these 1,024 rows), so hymba is held to
    one bf16 step of the rows' scale, and its 99th percentile to
    F32_RTOL."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(PL, "COMPUTE_DTYPE", torch.float32)
    cfg = jget(arch).reduced()
    key = jax.random.PRNGKey(0)
    params = JT.init_params(cfg, key)
    tokens = jax.random.randint(key, (16, 64), 0, cfg.vocab_size)
    frames = (jax.random.normal(key, (16, 16, cfg.frontend_dim))
              if cfg.family == "encdec" else None)
    want = _reference_H(cfg, params, tokens, frames)
    pcfg = pget(arch).reduced()
    model = convert.model_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    got = pex.harvest(pcfg, model, torch.from_numpy(np.array(tokens)).long(),
                      None if frames is None
                      else torch.from_numpy(np.array(frames)))
    assert got.dtype == torch.float32 and not got.is_inference()
    assert got.shape == want.shape == (1024, 128)
    err, scale = np.abs(got.numpy() - want), np.max(np.abs(want))
    assert np.quantile(err, 0.99) <= F32_RTOL * scale
    bound = BF16_STEP if cfg.family == "hybrid" else F32_RTOL
    assert np.max(err) <= bound * scale


LINE = re.compile(r"codebook quantization MSE/dim = \d+\.\d{5} "
                  r"\(activation variance \d+\.\d{5}, "
                  r"compression residual \d+\.\d%\)")


def test_reference_example_prints_the_lines_held(capsys, monkeypatch):
    """The reference example's two lines, which the port's are held to:
    the first word for word, the second in its format (one arch: the
    lines' shapes do not depend on it)."""
    ref = _reference_example()
    monkeypatch.setattr(sys, "argv", ["embedding_clustering.py", "--arch",
                                      "hymba-1.5b"])
    ref.main()
    want = capsys.readouterr().out.splitlines()
    assert want[0] == ("hymba-1.5b: clustering 1024 activation vectors "
                       "(128-d) into a 64-entry codebook")
    assert LINE.fullmatch(want[1])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_example_main_runs_as_the_reference(arch, capsys):
    """The port's ``main(["--device", "cpu"])`` prints the reference's two
    lines (see the test above) and fits the reference's codebook."""
    got = pex.main(["--arch", arch, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"{arch}: clustering 1024 activation vectors (128-d) "
                      "into a 64-entry codebook")
    assert LINE.fullmatch(out[1])
    assert (got["rows"], got["width"]) == (1024, 128)
    assert 0 < got["mse"] < got["variance"]
    res = got["result"]
    assert tuple(res.centroids.shape) == (64, 128)
    assert res.config.s == 512 and res.config.n_chunks == 25
    assert res.extras["fit"]["device"] == "cpu"


# ------------------------------------------------ clustering launcher

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "topology"} | {"topology": cfg.topology.kind}


def _capturing(fn, seen: list, **extra):
    def wrapper(data, config, **kw):
        result = fn(data, config, **kw, **extra)
        seen.append((config, kw, result))
        return result
    return wrapper


ARGV = ["--chunks", "8", "--scale", "0.0001", "--seed", "3"]


def test_launcher_matches_the_reference(monkeypatch, capsys):
    """Both launchers at a small ``--scale``: the configs they build equal
    field by field; the port, fed the reference's ``gmm_chunk`` rows as
    numpy (the two packages' generators draw other rows) under the
    jax-replay backend, reaches the reference's f_best and accepts."""
    seen_j, seen_p = [], []
    monkeypatch.setattr(jtrain, "fit", _capturing(jtrain.fit, seen_j))
    monkeypatch.setattr(sys, "argv", ["train.py", *ARGV])
    jtrain.main()
    want_out = capsys.readouterr().out.splitlines()

    def reference_rows(spec, cid, size, *, device):
        jspec = jsyn.GMMSpec(**spec._asdict())
        return np.asarray(jsyn.gmm_chunk(jspec, cid, size))

    monkeypatch.setattr(ptrain, "gmm_chunk", reference_rows)
    monkeypatch.setattr(ptrain, "fit", _capturing(ptrain.fit, seen_p,
                                                  rng=REPLAY))
    res = ptrain.main([*ARGV, "--device", "cpu"])
    got_out = capsys.readouterr().out.splitlines()

    (jcfg, jkw, jres), = seen_j
    (pcfg, pkw, pres), = seen_p
    assert pres is res
    assert _fields(pcfg) == _fields(jcfg)
    assert (pcfg.k, pcfg.s, pcfg.batch, pcfg.n_chunks, pcfg.seed) == \
        (25, 64_000, 8, 8, 3)
    assert str(pkw.pop("device")) == "cpu"
    assert pkw == jkw == dict(method="streaming", n_features=27)
    assert got_out[0] == want_out[0]
    assert res.strategy == jres.strategy == "streaming"
    assert res.objective == pytest.approx(jres.objective, rel=RTOL)
    assert (res.n_accepted, res.n_chunks) == (jres.n_accepted, jres.n_chunks)
    assert res.extras.get("chunks_failed", 0) == 0
    pat = re.compile(r"\[train\] done: f_best=(\S+) accepted=(\d+)/(\d+) "
                     r"failed=(\d+) wall=\S+s n_d=\S+")
    assert pat.fullmatch(got_out[1]).groups()[1:] == \
        pat.fullmatch(want_out[1]).groups()[1:]


def test_launcher_resumes_from_its_checkpoints(tmp_path, capsys):
    """``--ckpt`` writes the reference's step layout; a second call on the
    same directory resumes after the last step and reports the same
    f_best."""
    ckpt = str(tmp_path / "run")
    argv = ["--chunks", "8", "--scale", "0.0001", "--device", "cpu",
            "--ckpt", ckpt]
    first = ptrain.main(argv)
    again = ptrain.main(argv)
    assert sorted(p.name for p in Path(ckpt).iterdir()) == [
        "step_000000000008"]
    assert again.n_chunks == 0
    assert again.objective == first.objective
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].split()[2] == lines[3].split()[2]      # f_best=...


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_launcher_refuses_an_lm_arch(arch, monkeypatch):
    with pytest.raises(AssertionError, match="LM archs"):
        ptrain.main(["--arch", arch, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["train.py", "--arch", arch])
    with pytest.raises(AssertionError, match="LM archs"):
        jtrain.main()


# ------------------------------------------------ MoE combine

def test_moe_combine_is_the_reference_scatter_order():
    """``_combine`` adds each token's slot outputs in the reference's
    scatter-add order: a sequential bf16 scatter over the [E, cap] slots,
    slot by slot, bitwise (drops included)."""
    gen = torch.Generator().manual_seed(0)
    T, K, E, D = 40, 3, 6, 8
    top_e = torch.stack([torch.randperm(E, generator=gen)[:K]
                         for _ in range(T)])
    top_p = torch.rand((T, K), generator=gen)
    for cap in (T, 9, 3):
        slot_tok, _, slot_of = pmoe._slots(top_p, top_e, E, cap)
        ye = (torch.randn((E, cap, D), generator=gen) * 4).bfloat16()
        got = pmoe._combine(ye, slot_of)
        want = torch.zeros((T + 1, D), dtype=torch.bfloat16)
        for slot, tok in enumerate(slot_tok.reshape(-1).tolist()):
            want[tok] = want[tok] + ye.reshape(-1, D)[slot]
        assert torch.equal(got, want[:T])


def test_moe_forward_twice_is_bitwise():
    cfg = pget("deepseek-moe-16b").reduced()
    model = PT.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)))
    a, _ = PT.forward(cfg, model, tokens)
    b, _ = PT.forward(cfg, model, tokens)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_moe_decode_keeps_every_token(monkeypatch):
    """The decode's MoE keeps every token (capacity = T), as the
    reference's block_decode does with ``SERVE_MOE_CAP`` unset."""
    cfg = pget("qwen3-moe-235b-a22b").reduced()
    calls = []
    real = pmoe.moe_ffn
    monkeypatch.setattr(pmoe, "moe_ffn", lambda *a, **kw: calls.append(kw)
                        or real(*a, **kw))
    model = PT.init_params(cfg, 0, device="cpu")
    tok = torch.zeros((2, 4), dtype=torch.long)
    _, cache = PT.prefill(cfg, model, tok, 6)
    n_prefill = len(calls)
    PT.decode_step(cfg, model, cache, tok[:, :1], 4)
    assert calls[:n_prefill] == [{}] * n_prefill
    assert calls[n_prefill:] == [dict(no_drop=True)] * cfg.num_layers
