"""AdamW and learning-rate schedules, the reference's
``repro.train.optimizer``.

The arithmetic is the reference's, in its order (not ``torch.optim.AdamW``,
which folds the decay and the bias corrections otherwise): gradients in
f32, clipped by the global norm sqrt(sum ||g||^2); f32 moments
``b1 * m + (1 - b1) * g`` and ``b2 * v + (1 - b2) * g * g``; bias
corrections ``1 - b ** step`` in f32; ``delta = mhat / (sqrt(vhat) + eps)
+ wd * p`` and ``p - lr * delta`` in f32, cast back to the parameter's
dtype.

The state mirrors the parameters by name (``{name: tensor}``, the names of
``named_parameters()``); the step and the schedule's value are tensors on
the parameters' device, so an update reads nothing back to the host.
``update`` writes the new values into the parameters and the moments in
place (``torch._foreach_*`` under ``no_grad``) and returns them, as the
reference's returns new ones.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.0) -> Schedule:
    def sched(step):
        step = step.to(torch.float32)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return sched


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    mu: dict
    nu: dict


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def named(params) -> dict:
    """{name: tensor} of a module's parameters, or of a mapping as given."""
    if isinstance(params, dict):
        return params
    return dict(params.named_parameters())


def adamw(
    lr: Schedule | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float | None = 1.0,
) -> Optimizer:
    sched = constant(lr) if isinstance(lr, (int, float)) else lr

    def init(params) -> AdamWState:
        p = named(params)
        dev = next(iter(p.values())).device
        zeros = {k: torch.zeros_like(v, dtype=torch.float32)
                 for k, v in p.items()}
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu=zeros, nu={k: torch.zeros_like(v) for k, v in zeros.items()})

    @torch.no_grad()
    def update(grads: dict, state: AdamWState, params):
        """(params, state) after one step on ``grads`` ({name: tensor});
        ``params`` (a module or a {name: tensor} mapping) and the state's
        moments are updated in place."""
        p = named(params)
        keys = list(p)
        # f32 copies of the gradients (never the caller's tensors)
        g = [grads[k].to(torch.float32, copy=True) for k in keys]
        if grad_clip is not None:
            sq = torch._foreach_mul(g, g)
            gnorm = torch.sqrt(sum(torch.sum(s) for s in sq))
            scale = torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-12),
                                    1.0)
            torch._foreach_mul_(g, scale)
        step = state.step + 1
        stepf = step.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=stepf.device)
        b1t = 1.0 - torch.pow(one * b1, stepf)
        b2t = 1.0 - torch.pow(one * b2, stepf)
        lr_t = sched(step)

        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        gg = torch._foreach_mul(g, 1 - b2)
        torch._foreach_mul_(gg, g)
        torch._foreach_add_(nu, gg)
        del gg, g

        pf = [p[k].to(torch.float32) for k in keys]
        mhat = torch._foreach_div(mu, b1t)
        vhat = torch._foreach_div(nu, b2t)
        torch._foreach_sqrt_(vhat)
        torch._foreach_add_(vhat, eps)
        torch._foreach_div_(mhat, vhat)                 # mhat: the step
        del vhat
        torch._foreach_add_(mhat, torch._foreach_mul(pf, weight_decay))
        torch._foreach_mul_(mhat, lr_t)
        torch._foreach_sub_(pf, mhat)
        for k, new in zip(keys, pf):
            if new is not p[k]:
                p[k].copy_(new)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update)
