"""The model zoo's serving path in the port (``repro_torch.models``), held to
the reference's ``repro.models`` on the CPU.

Weights cross from the reference through
``convert.model_params_from_numpy``; inputs come from a numpy seed.  The
zoo computes in bf16, and one bf16 rounding can flip an MoE router's top-k
(a different expert, a different output), so whole stacks are held
tightly with ``COMPUTE_DTYPE = float32`` in both packages, and bf16 module
by module on identical inputs, each within a stated number of bf16 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.launch import roofline as jroof
from repro.models import flags as jflags
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.configs import shapes as pshapes
from repro_torch.launch import roofline as proof
from repro_torch.models import layers as PL
from repro_torch.models import moe as pmoe
from repro_torch.models import registry as preg
from repro_torch.models import ssm as pssm
from repro_torch.models import transformer as PT
from repro_torch.models.config import ModelConfig as PConfig

ARCHS = preg.LM_ARCHS
BF16_STEP = 2.0 ** -7        # bf16's spacing at 1.0 (8 significant bits)
F32_RTOL = 1e-4              # f32 compute: the f32 products and softmaxes
#                              associate differently (~1e-6 relative)
HYBRID_F32_STEPS = 1.0       # hymba at f32 compute keeps the SSD's hard-coded
#                              bf16 casts: an f32 value that differs in its
#                              last bits and rounds to the other bf16
#                              neighbour moves the logits after it by a
#                              fraction of a bf16 step (~3e-5 of the scale at
#                              2 x 40 tokens, 0.34 of a step over 1,024 rows
#                              in test_torch_zoo_entry.py); its 99th
#                              percentile is held to F32_RTOL


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The products here are small: two torch threads keep the suite's
    parallel workers from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------- helpers

def _vlm(cls):
    """A gemma-like VLM config the registry does not have: prefix-LM
    attention over 4 stub patches, softcaps, sandwich norms, scaled
    embeddings, geglu, local/global layers."""
    return cls(name="vlm-test", family="vlm", num_layers=2, d_model=64,
               num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
               vocab_size=512, window=8, layer_pattern="local_global",
               attn_softcap=50.0, final_softcap=30.0, sandwich_norm=True,
               scale_embedding=True, mlp="geglu", frontend="vision",
               frontend_dim=32, frontend_len=4)


def _configs(arch):
    if arch == "vlm":
        return _vlm(JConfig), _vlm(PConfig)
    return jreg.get_config(arch).reduced(), preg.get_config(arch).reduced()


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(PL, "COMPUTE_DTYPE", torch.float32)


def _models(jcfg, pcfg, seed=0):
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    model = convert.model_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    return params, model


def _inputs(cfg, B, S, seed=0):
    """tokens [B,S] and, for encdec / vlm, frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = None
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, 16, cfg.frontend_dim)).astype(np.float32)
    elif cfg.family == "vlm":
        frames = rng.normal(size=(B, cfg.frontend_len, cfg.frontend_dim)
                            ).astype(np.float32)
    return tokens, frames


def _forward(jcfg, pcfg, params, model, tokens, frames):
    jmod, pmod = jreg.model_fns(jcfg), preg.model_fns(pcfg)
    jt, pt = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    if jcfg.family == "encdec":
        want, _ = jmod.forward(jcfg, params, jt, jnp.asarray(frames))
        got, _ = pmod.forward(pcfg, model, pt, torch.from_numpy(frames))
    elif jcfg.family == "vlm":
        want, _ = jmod.forward(jcfg, params, jt, frontend=jnp.asarray(frames))
        got, _ = pmod.forward(pcfg, model, pt,
                              frontend=torch.from_numpy(frames))
    else:
        want, _ = jmod.forward(jcfg, params, jt)
        got, _ = pmod.forward(pcfg, model, pt)
    return got.numpy(), np.asarray(want, np.float32)


def _bf16(a):
    """The same bf16 values in both packages (f32 -> bf16 rounds to
    nearest even in both)."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _steps(got, want):
    """|got - want| in bf16 steps of want's largest magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = BF16_STEP * np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / scale)


def _f32_close(got, want, hybrid: bool) -> None:
    err, scale = np.abs(_np(got) - _np(want)), np.max(np.abs(_np(want)))
    assert np.quantile(err, 0.99) <= F32_RTOL * scale
    bound = HYBRID_F32_STEPS * BF16_STEP if hybrid else F32_RTOL
    assert np.max(err) <= bound * scale


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    j, p = jreg.get_config(arch), preg.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(p.reduced())
    for c in (j, j.reduced()):
        q = PConfig(**dataclasses.asdict(c))
        assert (q.param_count(), q.active_param_count(), q.d_inner,
                q.ssm_heads) == (c.param_count(), c.active_param_count(),
                                 c.d_inner, c.ssm_heads)


def test_registry_is_the_references():
    assert preg.list_archs() == jreg.list_archs()
    assert preg.LM_ARCHS == jreg.LM_ARCHS
    assert preg.get_config("hymba_1_5b") is preg.get_config("hymba-1.5b")
    paper = preg.get_config("bigmeans_paper")
    assert type(paper).__module__ == "repro_torch.configs.bigmeans_paper"
    assert (paper.m, paper.n_features, paper.k, paper.s) == (
        10_500_000, 27, 25, 64_000)
    with pytest.raises(KeyError, match="unknown arch"):
        preg.get_config("llama")
    assert preg.model_fns(preg.get_config("seamless-m4t-medium")).__name__ \
        == "repro_torch.models.encdec"
    assert preg.model_fns(preg.get_config("hymba-1.5b")).__name__ \
        == "repro_torch.models.transformer"


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_references(arch, shape):
    assert pshapes.SHAPES[shape] == pshapes.ShapeSpec(
        **dataclasses.asdict(jshapes.SHAPES[shape]))
    got = proof.model_flops(preg.get_config(arch), pshapes.SHAPES[shape])
    assert got == jroof.model_flops(jreg.get_config(arch),
                                    jshapes.SHAPES[shape])


@pytest.mark.parametrize("arch", ARCHS + ["vlm"])
def test_init_params_gives_the_references_leaves(arch):
    """Every reference leaf has a port parameter of its per-layer shape and
    dtype, drawn at the reference's scale (std within 10 % where the leaf
    is random and large)."""
    jcfg, pcfg = _configs(arch)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = PT.init_params(pcfg, 0, device="cpu")
    got = dict(model.named_parameters())
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(got) == sum(
        leaf.shape[0] if path[0].key in ("layers", "encoder") else 1
        for path, leaf in leaves)
    for path, leaf in leaves:
        keys = [k.key for k in path]
        stacked = keys[0] in ("layers", "encoder")
        for i in range(leaf.shape[0] if stacked else 1):
            name = ".".join([keys[0], str(i)] + keys[1:] if stacked else keys)
            t = got[name]
            want = np.asarray(leaf[i] if stacked else leaf)
            assert tuple(t.shape) == want.shape, name
            assert t.dtype == torch.float32 and want.dtype == np.float32
            assert not t.requires_grad
            if want.std() == 0:
                assert torch.equal(t, torch.from_numpy(np.array(want))), name
            elif want.size >= 4096:
                assert float(t.std()) == pytest.approx(float(want.std()),
                                                       rel=0.1), name


def test_init_params_is_seeded():
    cfg = preg.get_config("hymba-1.5b").reduced()
    a = PT.init_params(cfg, 3, device="cpu")
    b = PT.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = PT.init_params(cfg, 4, device="cpu")
    for (_, x), (_, y), (_, z) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(x, y)
    assert not torch.equal(a.embedding, c.embedding)


# ------------------------------------------------- whole stack, f32 compute

@pytest.mark.parametrize("arch", ARCHS + ["vlm"])
def test_forward_f32_matches_the_reference(arch, f32_compute):
    jcfg, pcfg = _configs(arch)
    params, model = _models(jcfg, pcfg)
    tokens, frames = _inputs(jcfg, 2, 40)
    got, want = _forward(jcfg, pcfg, params, model, tokens, frames)
    S = 40 + (jcfg.frontend_len if jcfg.family == "vlm" else 0)
    assert got.shape == want.shape == (2, S, jcfg.vocab_size)
    _f32_close(got, want, jcfg.hybrid)


def test_forward_f32_through_every_ssd_chunk(f32_compute):
    """hymba at 40 tokens runs 3 SSD chunks of 16 (one padded), so the
    inter-chunk recurrence and the dt = 0 padding are both held."""
    jcfg, pcfg = _configs("hymba-1.5b")
    assert jcfg.ssm_chunk == 16
    params, model = _models(jcfg, pcfg, seed=2)
    tokens, _ = _inputs(jcfg, 3, 37, seed=2)
    got, want = _forward(jcfg, pcfg, params, model, tokens, None)
    _f32_close(got, want, True)


# --------------------------------------------------- whole stack, bf16

@pytest.mark.parametrize("arch,steps", [("hymba-1.5b", 8.0),
                                        ("seamless-m4t-medium", 4.0)])
def test_forward_bf16_whole_stack(arch, steps, monkeypatch):
    """At bf16 the two packages round differently (each bf16 product and
    transcendental is rounded once from a slightly different f32 value),
    and the differences run through every layer.  Measured over seeds 0-2
    at B, S = 4, 64: hymba 3.7-4.0 bf16 steps of the logits' scale, seamless
    1.8-2.0, against the reference's own bf16-vs-f32 gap of ~0.22 and ~0.085
    (~6 and ~2 steps); the bounds are twice what was measured."""
    jcfg, pcfg = _configs(arch)
    params, model = _models(jcfg, pcfg)
    tokens, frames = _inputs(jcfg, 4, 64)
    got, want = _forward(jcfg, pcfg, params, model, tokens, frames)
    assert np.all(np.isfinite(got))
    assert _steps(got, want) <= steps
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.9


# ------------------------------------------------ bf16, module by module

def test_rmsnorm_and_rope_bf16():
    rng = np.random.default_rng(0)
    jx, px = _bf16(rng.normal(size=(2, 9, 4, 16)) * 3)
    scale = rng.normal(size=(16,)).astype(np.float32) * 0.1
    # one rounding of the f32 result: at most one step
    assert _steps(PL.rmsnorm(px, torch.from_numpy(scale)),
                  JL.rmsnorm(jx, jnp.asarray(scale))) <= 1.0
    pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0) * 37
    for theta in (10_000.0, 1_000_000.0):
        got = PL.rope(px, torch.from_numpy(pos), theta)
        want = JL.rope(jx, jnp.asarray(pos), theta)
        assert _steps(got, want) <= 1.0


ATTN_CASES = {
    "causal": dict(causal=True, window=None, prefix_len=None),
    "window": dict(causal=True, window=5, prefix_len=None),
    "prefix": dict(causal=True, window=None, prefix_len=4),
    "bidirectional": dict(causal=False, window=None, prefix_len=None),
}


@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa2", "mqa"])
def test_attention_core_bf16(case, heads, softcap):
    H, KV = heads
    rng = np.random.default_rng(1)
    B, S, hd = 2, 13, 16
    jq, pq = _bf16(rng.normal(size=(B, S, H, hd)) * 2)
    jk, pk = _bf16(rng.normal(size=(B, S, KV, hd)) * 2)
    jv, pv = _bf16(rng.normal(size=(B, S, KV, hd)))
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    cfg = dict(name="t", family="dense", num_layers=1, d_model=64,
               num_heads=H, num_kv_heads=KV, head_dim=hd, d_ff=32,
               vocab_size=8, attn_softcap=softcap)
    jcfg, pcfg = JConfig(**cfg), PConfig(**cfg)
    kw = ATTN_CASES[case]
    jm = JL._attn_mask(jnp.asarray(pos), jnp.asarray(pos), kv_valid=None, **kw)
    pm = PL._attn_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                       kv_valid=None, **kw)
    assert np.array_equal(np.asarray(jm), pm.numpy())
    want = JL.attention_core(jcfg, jq, jk, jv, jm)
    got = PL.attention_core(pcfg, pq, pk, pv, pm)
    # f32 logits and softmax, one rounding of the weights and of the output
    assert _steps(got, want) <= 2.0
    # the reference's blockwise form computes the same function: the port
    # (which materializes the logits) is held to it as well
    bw = JL.attention_core_blockwise(jcfg, jq, jk, jv, jnp.asarray(pos),
                                     jnp.asarray(pos), block=4, **kw)
    assert _steps(got, bw) <= 2.0


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "vlm", "hymba-1.5b"])
def test_self_attention_bf16_and_blockwise(arch, monkeypatch):
    """The projections, qk-norm (qwen3), RoPE and the core, held to the
    reference's materialized form and to its ``BLOCKWISE_ATTN = 16`` form
    over 40 tokens (three blocks, one padded); the port has one form."""
    jcfg, pcfg = _configs(arch)
    params, model = _models(jcfg, pcfg)
    rng = np.random.default_rng(3)
    jx, px = _bf16(rng.normal(size=(2, 40, jcfg.d_model)))
    pos = np.arange(40, dtype=np.int32)[None].repeat(2, 0)
    kw = dict(causal=True, window=jcfg.window,
              prefix_len=4 if jcfg.family == "vlm" else None)
    jp, pp = _layer0(params["layers"]["attn"]), model.layers[0].attn
    got, (pk, pv) = PL.self_attention(pcfg, pp, px, torch.from_numpy(pos),
                                      **kw)
    for block in (None, 16):
        monkeypatch.setattr(jflags, "BLOCKWISE_ATTN", block)
        want, (jk, jv) = JL.self_attention(jcfg, jp, jx, jnp.asarray(pos),
                                           **kw)
        assert _steps(pk, jk) <= 1.0 and _steps(pv, jv) <= 1.0
        assert _steps(got, want) <= 4.0


@pytest.mark.parametrize("form", ["swiglu", "geglu", "relu2"])
def test_mlp_bf16(form):
    base = jreg.get_config("hymba-1.5b").reduced()
    jcfg = dataclasses.replace(base, mlp=form)
    pcfg = PConfig(**dataclasses.asdict(jcfg))
    jp = JL.init_mlp(jax.random.PRNGKey(5), jcfg)
    pp = PL.init_mlp(pcfg, None, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, t in pp.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    jx, px = _bf16(np.random.default_rng(5).normal(size=(3, 7, 64)))
    # up, gate, the activation and the product each rounded to bf16 once
    assert _steps(PL.mlp(pcfg, pp, px), JL.mlp(jcfg, jp, jx)) <= 4.0


def test_ssd_full_and_decode_bf16():
    """hymba's mixer over 40 tokens (3 chunks of 16, one padded), then one
    decode step from its cache, on the same bf16 inputs."""
    jcfg, pcfg = _configs("hymba-1.5b")
    params, model = _models(jcfg, pcfg)
    jp, pp = _layer0(params["layers"]["ssm"]), model.layers[0].ssm
    rng = np.random.default_rng(6)
    jx, px = _bf16(rng.normal(size=(2, 40, 64)))
    want, jc = jssm.ssd_full(jcfg, jp, jx)
    got, pc = pssm.ssd_full(pcfg, pp, px)
    assert _steps(got, want) <= 6.0
    assert _steps(pc["conv"], jc["conv"]) <= 1.0
    assert _steps(pc["state"], jc["state"]) <= 2.0
    # decode from the reference's cache, as f32 (the decode cache's dtype)
    cache = {"conv": np.asarray(jc["conv"], np.float32),
             "state": np.asarray(jc["state"])}
    jx1, px1 = _bf16(rng.normal(size=(2, 1, 64)))
    want, jn = jssm.ssd_decode(jcfg, jp, jx1, jax.tree.map(jnp.asarray, cache))
    got, pn = pssm.ssd_decode(pcfg, pp, px1,
                              convert.cache_from_numpy(cache, device="cpu"))
    assert _steps(got, want) <= 4.0
    assert _steps(pn["state"], jn["state"]) <= 2.0
    assert np.array_equal(_np(pn["conv"]), _np(jn["conv"]))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_moe_ffn_bf16(arch):
    """Routes equal off near ties, then the FFN on the same bf16 inputs
    (capacity dispatch over all tokens, the reference's one group off a
    mesh)."""
    jcfg, pcfg = _configs(arch)
    params, model = _models(jcfg, pcfg)
    jp, pp = _layer0(params["layers"]["moe"]), model.layers[0].moe
    jx, px = _bf16(np.random.default_rng(7).normal(size=(2, 24, 64)))
    xt32 = px.float().reshape(-1, 64)
    probs = torch.softmax(xt32 @ pp.router, -1)
    top, _ = torch.sort(probs, -1, descending=True)
    K = pcfg.top_k
    tie = (top[:, K - 1] - top[:, K]) < 1e-5
    _, pe = pmoe.route(pcfg, pp, px.reshape(-1, 64))
    logits = jnp.einsum("td,de->te", jx.reshape(-1, 64).astype(jnp.float32),
                        jp["router"])
    _, je = jax.lax.top_k(jax.nn.softmax(logits, -1), K)
    off = ~tie.numpy()
    assert np.array_equal(pe.numpy()[off], np.asarray(je)[off])
    assert not tie.any()
    want = jmoe.moe_ffn(jcfg, jp, jx)
    got = pmoe.moe_ffn(pcfg, pp, px)
    assert _steps(got, want) <= 4.0
    # the drops of a tight capacity
    want = jmoe.moe_ffn(jcfg, jp, jx, capacity_override=0.5)
    got = pmoe.moe_ffn(dataclasses.replace(pcfg, capacity_factor=0.5), pp,
                       px)
    assert _steps(got, want) <= 4.0
    want = jmoe.moe_ffn(jcfg, jp, jx, no_drop=True)
    got = pmoe.moe_ffn(pcfg, pp, px, no_drop=True)
    assert _steps(got, want) <= 4.0


# ------------------------------------------------------- decode

CASES = [                    # tests/test_decode_consistency.py:19-23
    ("seamless-m4t-medium", 1e-3),
    ("deepseek-moe-16b", 1e-3),
    ("hymba-1.5b", 0.15),
    ("qwen3-moe-235b-a22b", 1e-3),
    ("vlm", 1e-3),
]


def _decode_cfgs(arch):
    jcfg, pcfg = _configs(arch)
    if jcfg.moe:             # no token drops in the forward either
        f = jcfg.num_experts / jcfg.top_k
        jcfg = dataclasses.replace(jcfg, capacity_factor=f)
        pcfg = dataclasses.replace(pcfg, capacity_factor=f)
    return jcfg, pcfg


def _prefill(pcfg, model, tokens, frames, S0, max_seq):
    mod = preg.model_fns(pcfg)
    if pcfg.family == "encdec":
        return mod.prefill(pcfg, model, tokens[:, :S0], frames, max_seq)
    return mod.prefill(pcfg, model, tokens[:, :S0], max_seq, frontend=frames)


@pytest.mark.parametrize("arch,tol", CASES)
def test_decode_matches_forward(arch, tol):
    """Prefill + single-token decode reproduce the forward's logits, at the
    reference's own tolerances (exact up to the f32 softmax for attention
    families; the SSD's chunked and recurrent forms sum differently)."""
    _, pcfg = _decode_cfgs(arch)
    model = PT.init_params(pcfg, 1, device="cpu")
    B, S, S0 = 2, 32, 24
    tokens, frames = _inputs(pcfg, B, S, seed=1)
    tokens = torch.from_numpy(tokens).long()
    frames = None if frames is None else torch.from_numpy(frames)
    mod = preg.model_fns(pcfg)
    offset = pcfg.frontend_len if pcfg.family == "vlm" else 0
    if pcfg.family == "encdec":
        full, _ = mod.forward(pcfg, model, tokens, frames)
    else:
        full, _ = mod.forward(pcfg, model, tokens, frontend=frames)
    _, cache = _prefill(pcfg, model, tokens, frames, S0, S + offset)
    for t in range(S0, S):
        lg, cache = mod.decode_step(pcfg, model, cache, tokens[:, t:t + 1],
                                    t + offset)
        err = float((lg - full[:, t + offset]).abs().max())
        assert err < tol, (t, err)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "seamless-m4t-medium",
                                  "deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_decode_from_the_references_cache(arch, monkeypatch):
    """The reference prefills; both packages decode three steps from that
    cache (``cache_from_numpy``).  At f32 compute the logits and the caches
    agree to F32_RTOL; at bf16 within 8 bf16 steps of the logits' scale
    (hymba's is the largest, ~3: its decode runs the SSD's state update and
    the attention, each rounded to bf16 in both packages)."""
    jcfg, pcfg = _decode_cfgs(arch)
    params, model = _models(jcfg, pcfg, seed=4)
    B, S, S0 = 2, 20, 17
    tokens, frames = _inputs(jcfg, B, S, seed=4)
    jmod, pmod = jreg.model_fns(jcfg), preg.model_fns(pcfg)

    def run(dtype_pair):
        monkeypatch.setattr(JL, "COMPUTE_DTYPE", dtype_pair[0])
        monkeypatch.setattr(PL, "COMPUTE_DTYPE", dtype_pair[1])
        jt = jnp.asarray(tokens[:, :S0])
        if jcfg.family == "encdec":
            _, jc = jmod.prefill(jcfg, params, jt, jnp.asarray(frames), S)
        else:
            _, jc = jmod.prefill(jcfg, params, jt, S)
        pc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc),
                                      device="cpu")
        out = []
        for t in range(S0, S):
            tok = tokens[:, t:t + 1]
            jl, jc = jmod.decode_step(jcfg, params, jc, jnp.asarray(tok),
                                      jnp.int32(t))
            pl, pc = pmod.decode_step(pcfg, model, pc,
                                      torch.from_numpy(tok).long(), t)
            out.append((pl.numpy(), np.asarray(jl)))
        return out, pc, jc

    out32, pc, jc = run((jnp.float32, torch.float32))
    for got, want in out32:
        _f32_close(got, want, jcfg.hybrid)
    got_c = convert.cache_to_numpy(pc)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        node = got_c
        for k in path:
            node = node[k.key]
        want = np.asarray(leaf, np.float32)
        assert node.shape == want.shape
        _f32_close(node, want, jcfg.hybrid)
    out16, _, _ = run((jnp.bfloat16, torch.bfloat16))
    for got, want in out16:
        assert np.all(np.isfinite(got))
        assert _steps(got, want) <= 8.0


def test_cache_roundtrip_keeps_bf16_bits():
    cfg = preg.get_config("hymba-1.5b").reduced()
    jcache = JT.init_cache(cfg, 2, 8)
    jcache = jax.tree.map(
        lambda a: jax.random.normal(jax.random.PRNGKey(0), a.shape, a.dtype),
        jcache)
    pc = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                  device="cpu")
    assert pc["k"].dtype == torch.bfloat16
    assert pc["ssm"]["state"].dtype == torch.float32
    back = convert.cache_to_numpy(pc)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, np.asarray(leaf, np.float32))
    want = PT.init_cache(cfg, 2, 8, device="cpu")
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jcache) == {
        k: ({kk: (tuple(vv.shape), str(vv.dtype).removeprefix("torch."))
             for kk, vv in v.items()} if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).removeprefix("torch.")))
        for k, v in want.items()}


def test_model_params_from_numpy_checks_the_tree():
    jcfg, pcfg = _configs("deepseek-moe-16b")
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    model = convert.model_params_from_numpy(pcfg, tree, device="cpu")
    assert np.array_equal(model.layers[1].moe.e_up.numpy(),
                          tree["layers"]["moe"]["e_up"][1])
    del tree["final_norm"]
    with pytest.raises(ValueError, match="leaves loaded"):
        convert.model_params_from_numpy(pcfg, tree, device="cpu")
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    tree["embedding"] = tree["embedding"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        convert.model_params_from_numpy(pcfg, tree, device="cpu")


def test_decode_gap_at_full_width_is_the_references():
    """hymba-1.5b at its published width (2 layers, B = 1, 520 tokens: 3
    SSD chunks of 256, one padded), the reference's weights: the port's
    gap between decoded and forward logits is the reference's own, within
    a bf16 step's worth of it.  The gap grows with depth and width (the
    SSD's chunked form rounds to bf16 where its recurrent form does not),
    so the reference's CPU bound of 0.15 at 2 layers of 64 wide does not
    carry to the full model; ``chip_smoke.py`` 14a holds the card's to
    its own bound."""
    jcfg = dataclasses.replace(jreg.get_config("hymba-1.5b"), num_layers=2)
    pcfg = dataclasses.replace(preg.get_config("hymba-1.5b"), num_layers=2)
    params, model = _models(jcfg, pcfg, seed=5)
    S, S0 = 520, 516
    tokens, _ = _inputs(jcfg, 1, S, seed=5)
    jfull, _ = JT.forward(jcfg, params, jnp.asarray(tokens))
    _, jc = JT.prefill(jcfg, params, jnp.asarray(tokens[:, :S0]), S)
    pt = torch.from_numpy(tokens).long()
    pfull, _ = PT.forward(pcfg, model, pt)
    _, pc = PT.prefill(pcfg, model, pt[:, :S0], S)
    want = got = 0.0
    for t in range(S0, S):
        jl, jc = JT.decode_step(jcfg, params, jc,
                                jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        pl, pc = PT.decode_step(pcfg, model, pc, pt[:, t:t + 1], t)
        want = max(want, float(jnp.max(jnp.abs(jl - jfull[:, t]))))
        got = max(got, float((pl - pfull[:, t]).abs().max()))
    scale = float(np.max(np.abs(np.asarray(jfull[:, S0:]))))
    print(f"decode gap at full width: reference {want:.4f}, port {got:.4f}, "
          f"logit scale {scale:.3f}")
    assert 0 < got <= want + BF16_STEP * scale
