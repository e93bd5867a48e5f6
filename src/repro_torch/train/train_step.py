"""Train / serve / prefill steps of the LM zoo, the reference's
``repro.train.train_step``.

``make_train_step``: loss -> gradients -> AdamW, bf16 compute with f32
parameters and optimizer state, each layer recomputed in the backward as
``flags.REMAT_POLICY`` says.  The loss is differentiated against copies
of the parameters (:func:`value_and_grad`): the f32 values themselves, or
under ``flags.BF16_GRADS`` bf16 copies of those with more than one
dimension, so that the gradients are bf16 while AdamW updates the f32
masters.  The model (the ``params`` argument) is updated in place and
returned, as are the optimizer's moments.

``make_serve_step``: one decoded token against the cache.
``make_prefill_step``: the prompt into a cache of ``max_seq`` positions.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import flags
from repro_torch.models.registry import model_fns
from repro_torch.train import sharding
from repro_torch.train.optimizer import Optimizer


class _Loss(nn.Module):
    """The loss and its gradients, as one call for ``functional_call`` (the
    backward's recomputation reads the same parameters as the forward)."""

    def __init__(self, cfg, model):
        super().__init__()
        self.cfg, self.model = cfg, model

    def forward(self, batch, leaves):
        loss = model_fns(self.cfg).loss_fn(self.cfg, self.model, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)


def value_and_grad(cfg, params: nn.Module, batch: dict):
    """(loss, {name: gradient}) of the arch's ``loss_fn`` at ``params``'
    values, f32 or (``flags.BF16_GRADS``) bf16 where a parameter has more
    than one dimension; ``params`` is read, never changed."""
    named = dict(params.named_parameters())
    leaves = {}
    for name, p in named.items():
        p = p.detach()
        if flags.BF16_GRADS and p.dtype == torch.float32 and p.ndim > 1:
            p = p.to(torch.bfloat16)
        leaves[name] = p.requires_grad_(True)
    wrapper = _Loss(cfg, params)
    with torch.enable_grad():
        loss, grads = torch.func.functional_call(
            wrapper, {f"model.{k}": v for k, v in leaves.items()},
            (batch, list(leaves.values())))
    if sharding._current_mesh() is not None:
        # each gradient placed as its parameter: a partial sum is reduced
        # here (the optimizer's global norm squares it)
        grads = [sharding.like(g, p) for g, p in zip(grads, named.values())]
    return loss, dict(zip(named, grads))


def make_train_step(cfg, opt: Optimizer):
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(cfg, params, batch)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss}

    return train_step


def make_serve_step(cfg):
    mod = model_fns(cfg)

    def serve_step(params, cache, token, pos):
        logits, new_cache = mod.decode_step(cfg, params, cache, token, pos)
        # under a mesh the argmax reads whole rows (DTensor's argmax over a
        # split vocabulary reads the host); the identity off a mesh
        whole = sharding.shard(logits, "batch", None)
        next_token = torch.argmax(whole, dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return serve_step


def make_prefill_step(cfg, max_seq: int):
    mod = model_fns(cfg)

    if cfg.family == "encdec":
        def prefill_step(params, tokens, frontend):
            return mod.prefill(cfg, params, tokens, frontend, max_seq)
    elif cfg.family == "vlm":
        def prefill_step(params, tokens, frontend):
            return mod.prefill(cfg, params, tokens, max_seq,
                               frontend=frontend)
    else:
        def prefill_step(params, tokens):
            return mod.prefill(cfg, params, tokens, max_seq)

    return prefill_step
