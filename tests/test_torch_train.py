"""The zoo's training path in the port (``repro_torch.train``, the
differentiable model bodies, the losses, remat and the switches of
``repro_torch.models.flags``), held to the reference's on the CPU.

Weights cross through ``convert.model_params_from_numpy``, inputs come from
a numpy seed.  As in ``test_torch_models.py``, whole stacks are held at
``COMPUTE_DTYPE = float32`` in both packages (a bf16 rounding can flip an
MoE router) and bf16 module by module.  Gradients are held leaf by leaf:
the largest error and the 99th percentile within ``F32_RTOL`` of the
leaf's largest magnitude, hymba's within its SSD allowance
(``HYBRID_GRAD_STEPS``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import (BF16_STEP, F32_RTOL, HYBRID_F32_STEPS, _bf16,
                               _configs, _inputs, _layer0, _models, _steps)

from repro.models import encdec as jencdec
from repro.models import flags as jflags
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.models import encdec as pencdec
from repro_torch.models import flags as pflags
from repro_torch.models import layers as PL
from repro_torch.models import moe as pmoe
from repro_torch.models import registry as preg
from repro_torch.models import ssm as pssm
from repro_torch.models import transformer as PT
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pts

ARCHS = preg.LM_ARCHS
LR = 1e-3
OPT_RTOL = 1e-6              # the optimizer on identical gradients: f32
#                              arithmetic in the same order (pow, sqrt and
#                              the global-norm sum may differ in an ulp), of
#                              each leaf's largest magnitude (an element
#                              that p - lr * delta brings near zero keeps
#                              the absolute error of its old value)
HYBRID_GRAD_STEPS = (HYBRID_F32_STEPS, 0.1)  # hymba at f32 compute keeps
#                              the SSD's bf16 casts: an f32 value rounding to
#                              the other bf16 neighbour moves the gradients
#                              behind it.  Seeds 0-3 at 32 and 40 tokens:
#                              largest error 7.9e-4 of a leaf's scale
#                              (0.10 bf16 step, conv_w), 99th percentile
#                              2.6e-4 (0.033 step); held to one bf16 step
#                              (as its forward) and to 0.1 step


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(PL, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture
def flag(monkeypatch):
    """Set a switch in both packages' ``flags`` for one test."""
    def set_(name, value):
        monkeypatch.setattr(jflags, name, value)
        monkeypatch.setattr(pflags, name, value)
    return set_


def _batch(cfg, B, S, seed=0):
    """(reference batch, port batch): tokens, labels (a few -1) and, for
    encdec / vlm, frames."""
    tokens, frames = _inputs(cfg, B, S, seed)
    labels = np.random.default_rng(seed + 100).integers(
        0, cfg.vocab_size, tokens.shape).astype(np.int32)
    labels[0, :3] = -1
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    pb = {"tokens": torch.from_numpy(tokens).long(),
          "labels": torch.from_numpy(labels).long()}
    if frames is not None:
        jb["frontend"] = jnp.asarray(frames)
        pb["frontend"] = torch.from_numpy(frames)
    return jb, pb


def _ref_value_and_grad(jcfg, params, jb):
    loss, g = jax.value_and_grad(
        lambda p: jreg.model_fns(jcfg).loss_fn(jcfg, p, jb))(params)
    return float(loss), convert.named_leaves(jax.tree.map(np.asarray, g))


def _grads_close(got: dict, want: dict, hybrid: bool) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        g = (g.float() if isinstance(g, torch.Tensor) else
             torch.as_tensor(g)).numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        err, scale = np.abs(g - w), np.max(np.abs(w))
        top, q99 = ((HYBRID_GRAD_STEPS[0] * BF16_STEP,
                     HYBRID_GRAD_STEPS[1] * BF16_STEP) if hybrid
                    else (F32_RTOL, F32_RTOL))
        assert np.quantile(err, 0.99) <= q99 * scale, name
        assert np.max(err) <= top * scale, name


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------ loss and grads, f32

@pytest.mark.parametrize("arch", ARCHS + ["vlm"])
def test_loss_and_grads_f32_match_the_reference(arch, f32_compute):
    """``loss_fn`` and every gradient leaf (``jax.grad`` against
    ``torch.autograd``) at f32 compute; the VLM's image prefix labelled
    -1 and three text labels -1."""
    jcfg, pcfg = _configs(arch)
    params, model = _models(jcfg, pcfg)
    jb, pb = _batch(jcfg, 2, 40)
    want, jg = _ref_value_and_grad(jcfg, params, jb)
    got, pg = pts.value_and_grad(pcfg, model, pb)
    assert abs(float(got) - want) <= F32_RTOL * abs(want)
    _grads_close(pg, jg, jcfg.hybrid)
    # the model itself is read, never changed or made trainable
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", ["hymba-1.5b", "seamless-m4t-medium",
                                  "vlm"])
def test_loss_is_nll_of_the_serving_forward(arch):
    """At bf16 compute the loss is ``_nll`` of the inference forward's
    logits, bitwise: the serving wrapper runs the same ops."""
    _, pcfg = _configs(arch)
    model = PT.init_params(pcfg, 3, device="cpu")
    _, pb = _batch(pcfg, 2, 24, seed=3)
    mod = preg.model_fns(pcfg)
    if pcfg.family == "encdec":
        logits, _ = mod.forward(pcfg, model, pb["tokens"], pb["frontend"])
        labels = pb["labels"]
    else:
        logits, _ = mod.forward(pcfg, model, pb["tokens"],
                                frontend=pb.get("frontend"))
        labels = pb["labels"]
        if pcfg.family == "vlm":
            labels = torch.cat([torch.full((2, pcfg.frontend_len), -1),
                                labels], 1)
    tot, cnt = PT._nll(logits, labels)
    loss, _ = pts.value_and_grad(pcfg, model, pb)
    assert torch.equal(loss, tot / cnt)
    assert int(cnt) == labels.numel() - 3 - (
        2 * pcfg.frontend_len if pcfg.family == "vlm" else 0)


def test_nll_matches_the_reference():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 7, 11)) * 4).astype(np.float32)
    labels = rng.integers(-1, 11, (3, 7)).astype(np.int32)
    jt, jc = JT._nll(jnp.asarray(logits), jnp.asarray(labels))
    pt, pc = PT._nll(torch.from_numpy(logits), torch.from_numpy(labels))
    assert int(pc) == int(jc) == int((labels >= 0).sum())
    assert float(pt) == pytest.approx(float(jt), rel=1e-6)


# ------------------------------------------------ loss and grads, bf16

def _vjp_close(jfn, pfn, jargs, pargs, seed, steps):
    """The output and the vjp of a random cotangent for every input, held
    within ``steps`` bf16 steps of the reference's scale each."""
    jout, jvjp = jax.vjp(jfn, *jargs)
    pargs = [a.detach().requires_grad_(True) for a in pargs]
    pout = pfn(*pargs)
    assert _steps(pout.detach(), jout) <= steps["out"]
    ct = np.random.default_rng(seed).normal(
        size=np.shape(jout)).astype(np.float32)
    jct, pct = _bf16(ct)
    jgrads = jvjp(jct.astype(jout.dtype))
    pgrads = torch.autograd.grad(pout, pargs, pct.to(pout.dtype))
    got = [_steps(pg, jg) for pg, jg in zip(pgrads, jgrads)]
    assert max(got) <= steps["grad"], got
    return got


def _params_of(module, ref: dict):
    """The port module's tensors in the reference dict's leaf order (bf16),
    and the reference's."""
    names = sorted(convert.named_leaves(jax.tree.map(np.asarray, ref)))
    named = dict(module.named_parameters())
    flat = convert.named_leaves(jax.tree.map(np.asarray, ref))
    jvals = [jnp.asarray(flat[n], jnp.bfloat16) for n in names]
    pvals = [named[n].detach().bfloat16() for n in names]
    return names, jvals, pvals


def _unflat(names, vals):
    tree = {}
    for n, v in zip(names, vals):
        node = tree
        *head, last = n.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


MODULE_STEPS = {             # bf16 steps of the output's and each vjp's
    #                          scale; seeds 0-2 of inputs and cotangent gave
    #                          attn 0 / 0 (every rounding the same), mlp 0.70
    #                          / 1.22, ssd 1.48 / 3.14, moe 1.26 / 1.51: about
    #                          twice that (attn one rounding)
    "attn": {"out": 1.0, "grad": 1.0},
    "mlp": {"out": 1.5, "grad": 2.5},
    "ssd": {"out": 3.0, "grad": 6.5},
    "moe": {"out": 2.5, "grad": 3.0},
}


@pytest.mark.parametrize("module", list(MODULE_STEPS))
def test_module_grads_bf16(module):
    """Each module's output and its vjp (input and parameters) at bf16, on
    the same bf16 inputs, weights and cotangent."""
    arch = {"attn": "qwen3-moe-235b-a22b", "mlp": "hymba-1.5b",
            "ssd": "hymba-1.5b", "moe": "deepseek-moe-16b"}[module]
    jcfg, pcfg = _configs(arch)
    params, model = _models(jcfg, pcfg)
    key = {"attn": "attn", "mlp": "mlp", "ssd": "ssm", "moe": "moe"}[module]
    jp, pp = _layer0(params["layers"][key]), getattr(model.layers[0], key)
    names, jvals, pvals = _params_of(pp, jp)
    rng = np.random.default_rng(11)
    S = 40
    jx, px = _bf16(rng.normal(size=(2, S, jcfg.d_model)))
    pos = np.arange(S, dtype=np.int32)[None].repeat(2, 0)

    def jfn(x, *vals):
        p = _unflat(names, vals)
        if module == "attn":
            return JL.self_attention(jcfg, p, x, jnp.asarray(pos),
                                     window=jcfg.window)[0]
        if module == "mlp":
            return JL.mlp(jcfg, p, x)
        if module == "ssd":
            return jssm.ssd_full(jcfg, p, x)[0]
        return jmoe.moe_ffn(jcfg, p, x)

    def pfn(x, *vals):
        p = torch.func.functional_call
        fn = {"attn": lambda m, x: PL.self_attention(
                  pcfg, m, x, torch.from_numpy(pos), window=pcfg.window)[0],
              "mlp": lambda m, x: PL.mlp(pcfg, m, x),
              "ssd": lambda m, x: pssm.ssd_full(pcfg, m, x)[0],
              "moe": lambda m, x: pmoe.moe_ffn(pcfg, m, x)}[module]

        class Call(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.m = pp

            def forward(self, x):
                return fn(self.m, x)

        return p(Call(), {f"m.{n}": v for n, v in zip(names, vals)}, (x,))

    _vjp_close(jfn, pfn, [jx, *jvals], [px, *pvals], 12,
               MODULE_STEPS[module])


def test_ssd_grads_at_the_published_chunk(f32_compute):
    """hymba's SSD over one chunk of 256 tokens (its published
    ``ssm_chunk``): above the diagonal the decay's exponent grows past
    f32's range, and the reference's backward multiplies the masked zero
    gradient by exp's inf (NaN gradients, its training at full width
    diverges).  The port masks the exponent too: with A small enough that
    nothing overflows, its gradients are the reference's (hymba's
    allowance); at the init's A = -1 they stay finite where the
    reference's are not, and the loss is the reference's."""
    jcfg, pcfg = (dataclasses.replace(c, ssm_chunk=256)
                  for c in _configs("hymba-1.5b"))
    params, _ = _models(jcfg, pcfg)
    jb, pb = _batch(jcfg, 1, 256, seed=19)
    for a_log in (-3.0, 0.0):
        params["layers"]["ssm"]["A_log"] = jnp.full_like(
            params["layers"]["ssm"]["A_log"], a_log)
        model = convert.model_params_from_numpy(
            pcfg, jax.tree.map(np.asarray, params), device="cpu")
        want, jg = _ref_value_and_grad(jcfg, params, jb)
        got, pg = pts.value_and_grad(pcfg, model, pb)
        assert abs(float(got) - want) <= F32_RTOL * abs(want)
        assert all(bool(torch.isfinite(g).all()) for g in pg.values())
        if a_log < 0:
            _grads_close(pg, jg, True)
        else:
            assert not all(np.isfinite(g).all() for g in jg.values())


# ------------------------------------------------ chunked loss, remat

@pytest.mark.parametrize("arch", ["hymba-1.5b", "vlm",
                                  "seamless-m4t-medium"])
def test_chunked_loss(arch, f32_compute, flag):
    """``CHUNKED_LOSS = 16`` over 40 tokens (three chunks, one padded):
    the port's equals its unchunked loss and grads to f32 rounding, and
    the reference's chunked loss and grads within F32_RTOL (the reference
    chunks only the decoder-only loss; its encoder-decoder loss is the
    unchunked one)."""
    jcfg, pcfg = _configs(arch)
    params, model = _models(jcfg, pcfg)
    jb, pb = _batch(jcfg, 2, 40, seed=5)
    base, gbase = pts.value_and_grad(pcfg, model, pb)
    flag("CHUNKED_LOSS", 16)
    got, pg = pts.value_and_grad(pcfg, model, pb)
    assert abs(float(got) - float(base)) <= 1e-6 * abs(float(base))
    _grads_close(pg, {k: v.numpy() for k, v in gbase.items()}, False)
    want, jg = _ref_value_and_grad(jcfg, params, jb)
    assert abs(float(got) - want) <= F32_RTOL * abs(want)
    _grads_close(pg, jg, jcfg.hybrid)


class _BmmLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the products run, by whether they have a batch of 1."""

    def __init__(self):
        super().__init__()
        self.counts = {"projection": 0, "batched": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default:
            self.counts["projection" if args[0].shape[0] == 1
                        else "batched"] += 1
        elif func is torch.ops.aten.mm.default:
            self.counts["projection"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS + ["vlm"])
def test_remat_policies_are_bitwise(arch, flag):
    """The loss and every gradient under ``REMAT_POLICY`` "full", "dots"
    and None are the same bits (remat changes what is kept, never a
    value); the backward recomputes the projections under "full" and not
    under "dots", which recomputes the batched products."""
    _, pcfg = _configs(arch)
    model = PT.init_params(pcfg, 1, device="cpu")
    _, pb = _batch(pcfg, 2, 24, seed=1)
    out, logs = {}, {}
    for policy in (None, "full", "dots"):
        flag("REMAT_POLICY", policy)
        named = {k: v.detach().requires_grad_(True)
                 for k, v in model.named_parameters()}
        log = _BmmLog()
        with torch.enable_grad():
            value, grads = torch.func.functional_call(
                _LossCall(pcfg, model, log),
                {f"m.{k}": v for k, v in named.items()},
                (pb, list(named.values())))
        out[policy] = (value, dict(zip(named, grads)))
        logs[policy] = log.counts
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out[None][0]), policy
        assert _equal(out[policy][1], out[None][1]), policy
    assert logs["full"]["projection"] > logs[None]["projection"]
    assert logs["dots"]["projection"] == logs[None]["projection"]
    assert logs["dots"]["batched"] > logs[None]["batched"]


class _LossCall(torch.nn.Module):
    """The loss, then its gradients with the products of the backward
    (and of its recomputation) counted by ``log``."""

    def __init__(self, cfg, model, log):
        super().__init__()
        self.cfg, self.m, self.log = cfg, model, log

    def forward(self, batch, leaves):
        loss = preg.model_fns(self.cfg).loss_fn(self.cfg, self.m, batch)
        with self.log:
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads


def test_unknown_remat_policy_raises(flag):
    _, pcfg = _configs("hymba-1.5b")
    model = PT.init_params(pcfg, 0, device="cpu")
    _, pb = _batch(pcfg, 1, 8)
    flag("REMAT_POLICY", "everything")
    with pytest.raises(ValueError, match="REMAT_POLICY"):
        pts.value_and_grad(pcfg, model, pb)


@pytest.mark.parametrize("arch", ARCHS + ["vlm"])
def test_train_step_under_anomaly_detection(arch):
    """No in-place op overwrites a tensor that the backward reads (the
    attention mask written into the logits, the cache paths): a step under
    ``torch.autograd.set_detect_anomaly`` raises nothing and gives the same
    bits as one without."""
    _, pcfg = _configs(arch)
    _, pb = _batch(pcfg, 2, 24, seed=2)
    opt = popt.adamw(LR)
    out = []
    for anomaly in (False, True):
        model = PT.init_params(pcfg, 2, device="cpu")
        state = opt.init(model)
        with torch.autograd.set_detect_anomaly(anomaly):
            model, state, m = pts.make_train_step(pcfg, opt)(model, state,
                                                             pb)
        out.append((m["loss"], dict(model.named_parameters())))
    assert torch.equal(out[0][0], out[1][0])
    assert _equal(out[0][1], out[1][1])


# ------------------------------------------------ optimizer

def _leaves(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            shapes.items()}


SHAPES = {"a": (7, 5), "b": (13,), "c.d": (3, 4, 2)}


@pytest.mark.parametrize("clip,grad_scale", [(1.0, 1.0), (1.0, 1e-3),
                                             (None, 1.0)],
                         ids=["clipped", "under-clip", "no-clip"])
def test_adamw_matches_the_reference_on_identical_grads(clip, grad_scale):
    """Three steps of both optimizers on the same parameters and gradients
    (the warmup-cosine schedule, weight decay on): parameters and both
    moments within OPT_RTOL of the reference's, the step count equal."""
    sched_j = jopt.warmup_cosine(1e-2, warmup=2, total=10)
    sched_p = popt.warmup_cosine(1e-2, warmup=2, total=10)
    jo, po = jopt.adamw(sched_j, grad_clip=clip), popt.adamw(
        sched_p, grad_clip=clip)
    params = _leaves(0, SHAPES)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = jo.init(jp), po.init(pp)
    for i in range(3):
        g = {k: v * grad_scale for k, v in _leaves(10 + i, SHAPES).items()}
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        pp, ps = po.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ps, pp)
        for k in SHAPES:
            for got, want in ((pp[k], jp[k]), (ps.mu[k], js.mu[k]),
                              (ps.nu[k], js.nu[k])):
                want = np.asarray(want)
                assert np.max(np.abs(got.numpy() - want)) <= \
                    OPT_RTOL * np.max(np.abs(want)), k
        assert int(ps.step) == int(js.step) == i + 1
        assert ps.step.dtype == torch.int32


def test_adamw_keeps_the_callers_grads_and_dtype():
    po = popt.adamw(0.1)
    p = {"w": torch.tensor([1.0, -2.0]), "h": torch.ones(2, dtype=
                                                         torch.bfloat16)}
    g = {"w": torch.tensor([0.5, 0.5]), "h": torch.ones(2,
                                                        dtype=torch.bfloat16)}
    keep = {k: v.clone() for k, v in g.items()}
    s = po.init(p)
    assert s.mu["h"].dtype == torch.float32
    p2, s2 = po.update(g, s, p)
    assert p2 is p and p["h"].dtype == torch.bfloat16
    assert _equal(g, keep)


def test_adamw_decreases_quadratic():
    """The reference's ``test_adamw_decreases_quadratic``."""
    opt = popt.adamw(0.1, weight_decay=0.0)
    p = {"w": torch.tensor([3.0, -2.0])}
    s = opt.init(p)
    for _ in range(50):
        p, s = opt.update({"w": 2 * p["w"]}, s, p)
    assert float(torch.sum(p["w"] ** 2)) < 0.1


def test_warmup_cosine_schedule():
    """The reference's ``test_warmup_cosine_schedule``, and the schedule
    equal to the reference's at every step (f32)."""
    sched = popt.warmup_cosine(1.0, warmup=10, total=100)
    assert float(sched(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(sched(torch.tensor(10, dtype=torch.int32))) - 1.0) \
        < 1e-6
    assert float(sched(torch.tensor(100, dtype=torch.int32))) < 1e-3
    for peak, warm, total, floor in ((1.0, 10, 100, 0.0),
                                     (3e-4, 0, 50, 1e-5)):
        js = jopt.warmup_cosine(peak, warm, total, floor)
        ps = popt.warmup_cosine(peak, warm, total, floor)
        for step in range(0, total + 5):
            got = float(ps(torch.tensor(step, dtype=torch.int32)))
            want = float(js(jnp.int32(step)))
            # f32 cos(pi t) may differ in an ulp between the packages, and
            # 1 + cos near t = 1 keeps that ulp: within OPT_RTOL of peak
            assert abs(got - want) <= OPT_RTOL * peak, step
    assert float(popt.constant(0.5)(torch.tensor(3))) == 0.5


# ------------------------------------------------ serving-path switches

def test_rope_bf16(flag):
    rng = np.random.default_rng(14)
    jx, px = _bf16(rng.normal(size=(2, 9, 4, 16)) * 3)
    pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0) * 37
    flag("ROPE_BF16", True)
    for theta in (10_000.0, 1_000_000.0):
        got = PL.rope(px, torch.from_numpy(pos), theta)
        want = JL.rope(jx, jnp.asarray(pos), theta)
        # bf16 products of bf16 tables: a step or two of the output
        assert _steps(got, want) <= 2.0
    flag("ROPE_BF16", False)
    f32 = PL.rope(px, torch.from_numpy(pos), 10_000.0)
    flag("ROPE_BF16", True)
    assert not torch.equal(f32, PL.rope(px, torch.from_numpy(pos),
                                        10_000.0))


@pytest.mark.parametrize("softcap", [None, 20.0])
def test_attention_bf16_softmax(softcap, flag):
    rng = np.random.default_rng(15)
    B, S, H, KV, hd = 2, 13, 4, 2, 16
    jq, pq = _bf16(rng.normal(size=(B, S, H, hd)) * 2)
    jk, pk = _bf16(rng.normal(size=(B, S, KV, hd)) * 2)
    jv, pv = _bf16(rng.normal(size=(B, S, KV, hd)))
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    cfg = dict(name="t", family="dense", num_layers=1, d_model=64,
               num_heads=H, num_kv_heads=KV, head_dim=hd, d_ff=32,
               vocab_size=8, attn_softcap=softcap)
    jcfg = jreg.get_config("hymba-1.5b").__class__(**cfg)
    pcfg = preg.get_config("hymba-1.5b").__class__(**cfg)
    kw = dict(causal=True, window=5, prefix_len=None, kv_valid=None)
    jm = JL._attn_mask(jnp.asarray(pos), jnp.asarray(pos), **kw)
    pm = PL._attn_mask(torch.from_numpy(pos), torch.from_numpy(pos), **kw)
    flag("ATTN_BF16_SOFTMAX", True)
    want = JL.attention_core(jcfg, jq, jk, jv, jm)
    got = PL.attention_core(pcfg, pq, pk, pv, pm)
    # every op of the softmax rounded to bf16 in both packages
    assert _steps(got, want) <= 4.0


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "vlm",
                                  "hymba-1.5b"])
def test_blockwise_attention(arch, flag):
    """``BLOCKWISE_ATTN = 16`` over 40 tokens (three blocks, one padded):
    the port's blockwise self-attention against the reference's at bf16,
    and, at f32 compute, its output and gradients against the port's
    materialized form."""
    jcfg, pcfg = _configs(arch)
    params, model = _models(jcfg, pcfg)
    rng = np.random.default_rng(16)
    jx, px = _bf16(rng.normal(size=(2, 40, jcfg.d_model)))
    pos = np.arange(40, dtype=np.int32)[None].repeat(2, 0)
    kw = dict(causal=True, window=jcfg.window,
              prefix_len=4 if jcfg.family == "vlm" else None)
    jp, pp = _layer0(params["layers"]["attn"]), model.layers[0].attn
    flag("BLOCKWISE_ATTN", 16)
    want, _ = JL.self_attention(jcfg, jp, jx, jnp.asarray(pos), **kw)
    got, _ = PL.self_attention(pcfg, pp, px, torch.from_numpy(pos), **kw)
    assert _steps(got, want) <= 4.0

    x32 = px.float().requires_grad_(True)
    outs = []
    for block in (16, None):
        flag("BLOCKWISE_ATTN", block)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(PL, "COMPUTE_DTYPE", torch.float32)
            out, _ = PL.self_attention(pcfg, pp, x32, torch.from_numpy(pos),
                                       **kw)
            (g,) = torch.autograd.grad(out.square().sum(), x32)
        outs.append((out.detach(), g))
    for a, b in zip(*outs):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= F32_RTOL * scale


def test_ssd_bf16(flag):
    jcfg, pcfg = _configs("hymba-1.5b")
    params, model = _models(jcfg, pcfg)
    jp, pp = _layer0(params["layers"]["ssm"]), model.layers[0].ssm
    jx, px = _bf16(np.random.default_rng(17).normal(size=(2, 40, 64)))
    flag("SSD_BF16", True)
    want, jc = jssm.ssd_full(jcfg, jp, jx)
    got, pc = pssm.ssd_full(pcfg, pp, px)
    # the decay and scores rounded to bf16 in both: as the f32 form's 6
    assert _steps(got, want) <= 6.0
    assert _steps(pc["state"], jc["state"]) <= 2.0


@pytest.mark.parametrize("cap", [1.0, 0.25])
def test_serve_moe_cap(cap, f32_compute, flag):
    """``SERVE_MOE_CAP``: decode's expert buffers at that factor (a factor
    of 0.25 drops decoded tokens) in both packages, from the same cache."""
    jcfg, pcfg = _configs("deepseek-moe-16b")
    params, model = _models(jcfg, pcfg, seed=18)
    tokens, _ = _inputs(jcfg, 4, 12, seed=18)
    _, jc = JT.prefill(jcfg, params, jnp.asarray(tokens[:, :10]), 12)
    pc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    flag("SERVE_MOE_CAP", cap)
    tok = tokens[:, 10:11]
    jl, _ = JT.decode_step(jcfg, params, jc, jnp.asarray(tok), jnp.int32(10))
    pl, _ = PT.decode_step(pcfg, model, pc, torch.from_numpy(tok).long(), 10)
    scale = float(jnp.max(jnp.abs(jl)))
    assert np.max(np.abs(pl.numpy() - np.asarray(jl))) <= F32_RTOL * scale


def test_flags_hold_the_references_defaults():
    for name in ("BLOCKWISE_ATTN", "BF16_GRADS", "CHUNKED_LOSS",
                 "SERVE_MOE_CAP", "ATTN_BF16_SOFTMAX", "ROPE_BF16",
                 "SEQ_PARALLEL", "REMAT_POLICY", "MOE_GROUPED_DISPATCH",
                 "KV_SHARD_SEQ", "SSD_BF16"):
        assert getattr(pflags, name) == getattr(jflags, name), name


# ------------------------------------------------ parameters, state

def test_serving_forward_is_the_body_without_grad():
    """The serving ``forward`` (inference mode) is ``forward_body`` under
    ``no_grad`` and under autograd, bitwise; ``init_params`` stays frozen."""
    cfg = preg.get_config("hymba-1.5b").reduced()
    model = PT.init_params(cfg, 5, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    tokens = torch.from_numpy(_inputs(cfg, 2, 12, seed=5)[0]).long()
    a, _ = PT.forward(cfg, model, tokens)
    with torch.no_grad():
        b, _ = PT.forward_body(cfg, model, tokens)
    c, _ = PT.forward_body(cfg, model, tokens)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_named_leaves_round_trip():
    jcfg, pcfg = _configs("seamless-m4t-medium")
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(1)))
    model = convert.model_params_from_numpy(pcfg, tree, device="cpu")
    named = convert.named_leaves(tree)
    assert set(named) == set(dict(model.named_parameters()))
    for k, v in model.named_parameters():
        assert np.array_equal(v.numpy(), named[k])
    back = convert.stacked_tree(dict(model.named_parameters()))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)


def test_encdec_loss_is_the_references(f32_compute):
    jcfg, pcfg = _configs("seamless-m4t-medium")
    params, model = _models(jcfg, pcfg, seed=6)
    jb, pb = _batch(jcfg, 2, 20, seed=6)
    want = float(jencdec.loss_fn(jcfg, params, jb))
    got = float(pencdec.loss_fn(pcfg, model, pb))
    assert abs(got - want) <= F32_RTOL * want
