"""Mixture-of-Experts FFN with capacity-based sorted dispatch, the
reference's ``repro.models.moe``.

Token -> expert assignments are ranked inside each expert by a stable
argsort; tokens ranked at or past the capacity are dropped.  Dispatch is a
gather onto an [E, C] slot table, the experts run as batched products, and
the combine adds each token's outputs in ascending slot order (expert
major) in bf16, starting from zeros: the order of the reference's
scatter-add, with no atomics, so two runs give the same bits.

``flags.MOE_GROUPED_DISPATCH`` slots the tokens within G groups, each with
its own capacity (:func:`_grouped_moe`); -1, the default, is one group per
batch shard of the active mesh, so one group on the port's single card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import flags
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, cast, param
from repro_torch.train import sharding


class MoE(nn.Module):
    """router [D, E], e_gate / e_up [E, D, Fe], e_down [E, Fe, D], and the
    shared experts' gated MLP (``shared``) when the config has them."""

    def __init__(self, cfg: ModelConfig, gen, *, device, dtype):
        super().__init__()
        D, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        kw = dict(device=device, dtype=dtype)
        self.router = param(gen, (D, E), D ** -0.5, **kw)
        self.e_gate = param(gen, (E, D, Fe), D ** -0.5, **kw)
        self.e_up = param(gen, (E, D, Fe), D ** -0.5, **kw)
        self.e_down = param(gen, (E, Fe, D), Fe ** -0.5, **kw)
        if cfg.num_shared_experts:
            self.shared = MLP(D, Fe * cfg.num_shared_experts, True, gen, **kw)


def init_moe(cfg: ModelConfig, gen, *, device, dtype) -> MoE:
    return MoE(cfg, gen, device=device, dtype=dtype)


def _act(cfg: ModelConfig):
    # jax.nn.gelu's default is the tanh approximation
    if cfg.mlp == "geglu":
        return lambda t: F.gelu(t, approximate="tanh")
    return F.silu


def route(cfg: ModelConfig, p: MoE, xt):
    """Router in f32: (top_p [T,K] renormalized, top_e [T,K]), the experts
    by descending probability, ties to the lower index (``lax.top_k``)."""
    logits = torch.einsum("td,de->te", xt.float(), p.router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    return top_p / torch.sum(top_p, dim=-1, keepdim=True), top_e


def _slots(top_p, top_e, E: int, cap: int):
    """The [E, cap] slot table of ``T`` tokens' top-K choices.

    Returns (slot_tok [E,cap]: the token in each slot, T where empty;
    slot_gate [E,cap] f32; slot_of [T,K]: each token's slots in ascending
    order, E*cap where a choice was dropped)."""
    T, K = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)               # sort by expert
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank = torch.arange(T * K, device=dev) - starts[sorted_e]  # within-expert
    keep = rank < cap
    e_k, c_k, o_k = sorted_e[keep], rank[keep], order[keep]

    slot_tok = torch.full((E, cap), T, dtype=torch.int64, device=dev)
    slot_tok[e_k, c_k] = o_k // K
    slot_gate = torch.zeros((E, cap), dtype=torch.float32, device=dev)
    slot_gate[e_k, c_k] = top_p.reshape(-1)[o_k].float()
    slot_of = torch.full((T * K,), E * cap, dtype=torch.int64, device=dev)
    slot_of[o_k] = e_k * cap + c_k
    return slot_tok, slot_gate, torch.sort(slot_of.view(T, K), dim=1).values


def _dispatch(xt, slot_tok):
    """xe [E, C, D]: the slots' token rows, zeros in empty slots."""
    T = xt.shape[0]
    xe = xt[torch.clamp_max(slot_tok, T - 1)]
    return torch.where((slot_tok < T)[..., None], xe, torch.zeros_like(xe))


def _combine(ye, slot_of):
    """y [T, D]: each token's slot outputs added in ascending slot order in
    ``ye``'s dtype, from zeros (dropped choices add an exact zero row)."""
    D = ye.shape[-1]
    rows = torch.cat([ye.reshape(-1, D), ye.new_zeros((1, D))])
    y = torch.zeros((slot_of.shape[0], D), dtype=ye.dtype, device=ye.device)
    for j in range(slot_of.shape[1]):
        y = y + rows[slot_of[:, j]]
    return y


def _experts(cfg: ModelConfig, p: MoE, xe, slot_gate):
    act = _act(cfg)
    gate = torch.einsum("ecd,edf->ecf", cast(xe), cast(p.e_gate))
    up = torch.einsum("ecd,edf->ecf", cast(xe), cast(p.e_up))
    ye = torch.einsum("ecf,efd->ecd", act(gate) * up, cast(p.e_down))
    return ye * slot_gate[..., None].to(ye.dtype)


def _shared(cfg: ModelConfig, p: MoE, xt):
    sp, act = p.shared, _act(cfg)
    g_ = torch.einsum("td,df->tf", cast(xt), cast(sp.w_gate))
    u_ = torch.einsum("td,df->tf", cast(xt), cast(sp.w_up))
    return torch.einsum("tf,fd->td", act(g_) * u_, cast(sp.w_down))


def _grouped_moe(cfg: ModelConfig, p: MoE, xt, top_p, top_e, factor: float,
                 G: int):
    """Grouped dispatch: the T tokens in G groups of T / G, each slotted
    within its group at a capacity of its own (``factor * Tg * K / E``),
    gathered and combined within the group.  The expert products run once
    over every group's slots of an expert ([E, G * capg, D]), as the
    global path's [E, cap, D] do."""
    T, D = xt.shape
    E, K = cfg.num_experts, cfg.top_k
    Tg = T // G
    capg = max(int(factor * Tg * K / E + 0.5), 1)
    xe, gates, slot_of = [], [], []
    for g in range(G):
        rows = slice(g * Tg, (g + 1) * Tg)
        st, sg, so = _slots(top_p[rows], top_e[rows], E, capg)
        xe.append(_dispatch(xt[rows], st))
        gates.append(sg)
        slot_of.append(so)
    ye = _experts(cfg, p, torch.stack(xe, 1).reshape(E, G * capg, D),
                  torch.stack(gates, 1).reshape(E, G * capg))
    ye = ye.reshape(E, G, capg, D)
    return torch.cat([_combine(ye[:, g], slot_of[g]) for g in range(G)])


def _groups() -> int:
    """``flags.MOE_GROUPED_DISPATCH``, its auto value (-1) resolved: the
    active mesh's batch shards, 1 off a mesh."""
    G = flags.MOE_GROUPED_DISPATCH
    if G < 0:
        mesh = sharding._current_mesh()
        G = (sharding._axis_prod(mesh, sharding.physical_axes(mesh, "batch"))
             if mesh is not None else 1)
    return G


def moe_ffn(cfg: ModelConfig, p: MoE, x, *, no_drop: bool = False,
            capacity_override: float | None = None):
    """x [B, S, D] -> [B, S, D].  Router in f32, experts in bf16.

    ``no_drop=True`` sets capacity = T (single-token decode).
    ``capacity_override`` replaces ``cfg.capacity_factor``.  With more
    than one group (:func:`_groups`), tokens are slotted per group
    (:func:`_grouped_moe`) unless ``no_drop`` or T does not divide.
    """
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    top_p, top_e = route(cfg, p, xt)
    factor = capacity_override or cfg.capacity_factor
    G = _groups()
    if G > 1 and not no_drop and T % G == 0:
        y = _grouped_moe(cfg, p, xt, top_p, top_e, factor, G)
    else:
        cap = T if no_drop else min(max(int(factor * T * K / E + 0.5), 1), T)
        slot_tok, slot_gate, slot_of = _slots(top_p, top_e, E, cap)
        ye = _experts(cfg, p, _dispatch(xt, slot_tok), slot_gate)
        y = _combine(ye, slot_of)
    if cfg.num_shared_experts:
        y = y + _shared(cfg, p, xt)
    return y.reshape(B, S, D)
