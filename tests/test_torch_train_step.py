"""The zoo's train, serve and prefill steps in the port
(``repro_torch.train.train_step``, AdamW's state carried across) and its
grouped MoE dispatch, held to the reference's on the CPU; the helpers,
fixtures and tolerances are ``test_torch_train.py``'s.

A step's new parameters are held within ``step_check.step_gap_bound``:
the float64 gap AdamW itself puts between the two packages' gradients
(near-zero gradients may flip an element's update by up to 2 lr), plus
f32 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import (_bf16, _configs, _f32_close, _inputs, _layer0,
                               _models, _steps)
from test_torch_train import (  # noqa: F401  (fixtures used by name)
    F32_RTOL, LR, _batch, _grads_close, _ref_value_and_grad, _two_threads,
    f32_compute, flag)

from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.models import moe as pmoe
from repro_torch.models import registry as preg
from repro_torch.train import optimizer as popt
from repro_torch.train import step_check
from repro_torch.train import train_step as pts

ARCHS = preg.LM_ARCHS


# ------------------------------------------------ train step

def _ref_step(jcfg, params, jb, state=None):
    opt = jopt.adamw(LR)
    state = opt.init(params) if state is None else state
    return jts.make_train_step(jcfg, opt)(params, state, jb)


def _hold_step(pcfg, model0, new_model, state0, pg, jg, new_ref, step):
    """The port's new parameters against the reference's, within
    ``step_check.step_gap_bound`` of the two gradients."""
    p0 = {k: v.detach().clone() for k, v in model0.items()}
    bound = step_check.step_gap_bound(
        p0, {k: v for k, v in pg.items()}, jg, state0[0], state0[1], step,
        LR)
    got = {k: v.detach().numpy() for k, v in new_model.named_parameters()}
    for k, want in convert.named_leaves(new_ref).items():
        assert np.all(np.abs(got[k] - want) <= bound[k]), k


@pytest.mark.parametrize("arch", ARCHS + ["vlm"])
def test_train_step_matches_make_train_step(arch, f32_compute):
    """One train step of each package from the same weights, then a second
    from the reference's parameters and optimizer state carried into the
    port (``adamw_state_from_numpy``): the loss within F32_RTOL, the new
    parameters within the gap AdamW puts between the two packages'
    gradients (``step_check``), the moments within F32_RTOL of their
    scale, the state carried back equal in layout."""
    jcfg, pcfg = _configs(arch)
    params, model = _models(jcfg, pcfg)
    jb, pb = _batch(jcfg, 2, 32, seed=7)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    _, pg = pts.value_and_grad(pcfg, model, pb)
    _, jg = _ref_value_and_grad(jcfg, params, jb)
    new_ref, jstate, jm = _ref_step(jcfg, params, jb)
    opt = popt.adamw(LR)
    state = opt.init(model)
    zeros = {k: np.zeros(v.shape) for k, v in p0.items()}
    model, state, pm = pts.make_train_step(pcfg, opt)(model, state, pb)
    want = float(jm["loss"])
    assert abs(float(pm["loss"]) - want) <= F32_RTOL * abs(want)
    _hold_step(pcfg, p0, model, (zeros, zeros), pg, jg,
               jax.tree.map(np.asarray, new_ref), 1)
    back = convert.adamw_state_to_numpy(state)
    assert int(back.step) == int(jstate.step) == 1
    assert jax.tree.structure(back.mu) == jax.tree.structure(
        jax.tree.map(np.asarray, jstate.mu))
    for mine, ref in ((back.mu, jstate.mu), (back.nu, jstate.nu)):
        _grads_close(convert.named_leaves(mine),
                     convert.named_leaves(jax.tree.map(np.asarray, ref)),
                     jcfg.hybrid)

    # the second step, both from the reference's state
    ref_np = jax.tree.map(np.asarray, new_ref)
    model = convert.model_params_from_numpy(pcfg, ref_np, device="cpu")
    state = convert.adamw_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           device="cpu")
    p1 = {k: v.detach().clone() for k, v in model.named_parameters()}
    m0 = {k: v.numpy().copy() for k, v in state.mu.items()}
    v0 = {k: v.numpy().copy() for k, v in state.nu.items()}
    _, pg = pts.value_and_grad(pcfg, model, pb)
    _, jg = _ref_value_and_grad(jcfg, new_ref, jb)
    new_ref2, jstate2, jm2 = _ref_step(jcfg, new_ref, jb, jstate)
    model, state, pm2 = pts.make_train_step(pcfg, opt)(model, state, pb)
    want = float(jm2["loss"])
    assert abs(float(pm2["loss"]) - want) <= F32_RTOL * abs(want)
    assert want < float(jm["loss"])
    _hold_step(pcfg, p1, model, (m0, v0), pg, jg,
               jax.tree.map(np.asarray, new_ref2), 2)
    assert int(state.step) == 2


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-moe-16b"])
def test_bf16_grads_step_matches_the_reference(arch, flag, f32_compute):
    """A ``BF16_GRADS`` step (f32 compute on the bf16 weights, so that no
    router flips): the loss within F32_RTOL of the reference's, every
    gradient bf16 where its parameter has more than one dimension and
    within 2 bf16 steps of the reference's scale (each side rounds its f32
    gradient, and sums a repeated token's embedding rows, in bf16), the
    new f32 masters within ``step_check``'s gap of those gradients."""
    flag("BF16_GRADS", True)
    jcfg, pcfg = _configs(arch)
    params, model = _models(jcfg, pcfg)
    jb, pb = _batch(jcfg, 2, 32, seed=8)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    loss, pg = pts.value_and_grad(pcfg, model, pb)
    for k, g in pg.items():
        assert g.dtype == (torch.bfloat16 if p0[k].ndim > 1
                           else torch.float32), k
    p16 = jax.tree.map(lambda p: p.astype(jnp.bfloat16) if p.ndim > 1
                       else p, params)
    _, jg16 = jax.value_and_grad(
        lambda p: jreg.model_fns(jcfg).loss_fn(jcfg, p, jb))(p16)
    jg = convert.named_leaves(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jg16))
    for k, g in pg.items():
        assert _steps(g, jg[k]) <= 2.0, k
    new_ref, _, jm = _ref_step(jcfg, params, jb)
    opt = popt.adamw(LR)
    model, _, pm = pts.make_train_step(pcfg, opt)(model, opt.init(model), pb)
    assert torch.equal(pm["loss"], loss)
    want = float(jm["loss"])
    assert abs(float(loss) - want) <= F32_RTOL * abs(want)
    zeros = {k: np.zeros(v.shape) for k, v in p0.items()}
    _hold_step(pcfg, p0, model, (zeros, zeros), pg, jg,
               jax.tree.map(np.asarray, new_ref), 1)
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("arch", ARCHS + ["vlm"])
def test_serve_and_prefill_steps_match_the_reference(arch, f32_compute):
    """``make_prefill_step`` then three ``make_serve_step`` tokens: the
    logits within F32_RTOL (``_f32_close``'s one bf16 step at most: the
    decode cache is bf16, and a K / V element that rounds to the other
    bf16 neighbour moves a row's logits by a fraction of a step), each
    next token the reference's."""
    jcfg, pcfg = _configs(arch)
    if jcfg.moe:             # no token dropped in the forward
        f = jcfg.num_experts / jcfg.top_k
        jcfg = dataclasses.replace(jcfg, capacity_factor=f)
        pcfg = dataclasses.replace(pcfg, capacity_factor=f)
    params, model = _models(jcfg, pcfg, seed=9)
    tokens, frames = _inputs(jcfg, 2, 20, seed=9)
    S0, max_seq = 16, 20 + (jcfg.frontend_len if jcfg.family == "vlm"
                            else 0)
    jpre, ppre = jts.make_prefill_step(jcfg, max_seq), \
        pts.make_prefill_step(pcfg, max_seq)
    jt, pt = jnp.asarray(tokens[:, :S0]), torch.from_numpy(
        tokens[:, :S0]).long()
    if frames is None:
        jl, jc = jpre(params, jt)
        pl, pc = ppre(model, pt)
    else:
        jl, jc = jpre(params, jt, jnp.asarray(frames))
        pl, pc = ppre(model, pt, torch.from_numpy(frames))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=F32_RTOL * float(jnp.max(jnp.abs(jl))))
    jserve, pserve = jts.make_serve_step(jcfg), pts.make_serve_step(pcfg)
    off = jcfg.frontend_len if jcfg.family == "vlm" else 0
    for t in range(S0, 19):
        tok = tokens[:, t:t + 1]
        jn, jl, jc = jserve(params, jc, jnp.asarray(tok), jnp.int32(t + off))
        pn, pl, pc = pserve(model, pc, torch.from_numpy(tok).long(), t + off)
        assert pn.dtype == torch.int32
        assert np.array_equal(pn.numpy(), np.asarray(jn))
        _f32_close(pl.numpy(), np.asarray(jl), True)


# ------------------------------------------------ grouped MoE

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_grouped_moe_matches_the_reference(arch, f32_compute, flag):
    """``MOE_GROUPED_DISPATCH = 4`` at the config's capacity (drops per
    group) and at E / top_k: the loss and grads within F32_RTOL of the
    reference's grouped ones; at full capacity grouped equals global
    within 1e-6 (``tests/test_moe_grouped.py``); drops bounded."""
    jcfg, pcfg = _configs(arch)
    params, model = _models(jcfg, pcfg)
    jb, pb = _batch(jcfg, 4, 32, seed=10)
    flag("MOE_GROUPED_DISPATCH", 4)
    want, jg = _ref_value_and_grad(jcfg, params, jb)
    got, pg = pts.value_and_grad(pcfg, model, pb)
    assert abs(float(got) - want) <= F32_RTOL * abs(want)
    _grads_close(pg, jg, False)
    assert all(bool(torch.isfinite(g).all()) for g in pg.values())
    f = jcfg.num_experts / jcfg.top_k
    full = dataclasses.replace(pcfg, capacity_factor=f)
    grouped = float(pts.value_and_grad(full, model, pb)[0])
    flag("MOE_GROUPED_DISPATCH", 0)
    base = float(pts.value_and_grad(full, model, pb)[0])
    assert abs(base - grouped) < 1e-6
    assert abs(float(got) - base) / base < 0.25


def test_moe_capacity_override_and_groups(flag):
    """``moe_ffn``'s ``capacity_override`` and ``MOE_GROUPED_DISPATCH`` at
    bf16 on the same inputs, against the reference's."""
    jcfg, pcfg = _configs("deepseek-moe-16b")
    params, model = _models(jcfg, pcfg)
    jp, pp = _layer0(params["layers"]["moe"]), model.layers[0].moe
    jx, px = _bf16(np.random.default_rng(13).normal(size=(4, 12, 64)))
    for groups, cap in ((0, None), (0, 0.5), (2, 2.0), (4, None), (4, 0.5),
                        (-1, 2.0)):
        flag("MOE_GROUPED_DISPATCH", groups)
        want = jmoe.moe_ffn(jcfg, jp, jx, capacity_override=cap)
        got = pmoe.moe_ffn(pcfg, pp, px, capacity_override=cap)
        assert _steps(got, want) <= 4.0, (groups, cap)
    assert pmoe._groups() == 1            # auto, off a mesh


