"""Mixture-of-Experts FFN with capacity-based sorted dispatch, the
reference's ``repro.models.moe``.

Token -> expert assignments are ranked inside each expert by a stable
argsort; tokens ranked at or past the capacity are dropped.  Dispatch is a
gather onto an [E, C] slot table, the experts run as batched products, and
the combine adds each token's outputs in ascending slot order (expert
major) in bf16, starting from zeros: the order of the reference's
scatter-add, with no atomics, so two runs give the same bits.

``flags.MOE_GROUPED_DISPATCH`` slots the tokens within G groups, each with
its own capacity (:func:`_routed`); -1, the default, is one group per
batch shard of the active mesh, so one group on the port's single card.
"""
from __future__ import annotations

import types

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

    # the dropped choices write a spare column, cut off after: shapes stay
    # static (no boolean indexing), the kept slots' values are the same
    col = torch.where(keep, rank, cap)
    slot_tok = torch.full((E, cap + 1), T, dtype=torch.int64, device=dev)
    slot_tok[sorted_e, col] = order // K
    slot_gate = torch.zeros((E, cap + 1), dtype=torch.float32, device=dev)
    slot_gate[sorted_e, col] = top_p.reshape(-1)[order].float()
    slot_of = torch.full((T * K,), E * cap, dtype=torch.int64, device=dev)
    slot_of[order] = torch.where(keep, sorted_e * cap + rank, E * cap)
    return (slot_tok[:, :cap], slot_gate[:, :cap],
            torch.sort(slot_of.view(T, K), dim=1).values)


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
    g_ = sharding.project("td,df->tf", cast(xt), cast(sp.w_gate), "w_gate")
    u_ = sharding.project("td,df->tf", cast(xt), cast(sp.w_up), "w_up")
    return sharding.project("tf,fd->td", act(g_) * u_, cast(sp.w_down),
                            "w_down")


def _routed(cfg: ModelConfig, p, xt, factor: float, groups: int, *,
            no_drop: bool, grouped: bool, e0: int = 0):
    """The routed experts on the tokens ``xt`` [T, D], one core for the
    one-device path and each rank's shards: the tokens slotted within
    ``groups`` groups of T / groups, each at a capacity of its own
    (``factor * Tg * K / E``; at most Tg unless ``grouped``, as the
    reference's ungrouped path clamps it; Tg under ``no_drop``), the
    experts of ``p`` (``e0`` onward: ``p``'s slice of the expert axis, all
    of them off a mesh) run once over every group's slots of an expert
    ([El, groups * cap, D], as the reference's [E, cap, D]), and each token
    gets the outputs of the chosen experts that ``p`` holds."""
    T, D = xt.shape
    E, K, El = cfg.num_experts, cfg.top_k, p.e_gate.shape[0]
    Tg = T // groups
    cap = Tg if no_drop else max(int(factor * Tg * K / E + 0.5), 1)
    if not grouped:
        cap = min(cap, Tg)
    top_p, top_e = route(cfg, p, xt)
    xe, gates, slot_of = [], [], []
    for g in range(groups):
        rows = slice(g * Tg, (g + 1) * Tg)
        st, sg, so = _slots(top_p[rows], top_e[rows], E, cap)
        xe.append(_dispatch(xt[rows], st[e0:e0 + El]))
        gates.append(sg[e0:e0 + El])
        # slots of experts held elsewhere read the zero row
        mine = (so >= e0 * cap) & (so < (e0 + El) * cap)
        slot_of.append(torch.where(mine, so - e0 * cap, El * cap))
    ye = _experts(cfg, p, torch.stack(xe, 1).reshape(El, groups * cap, D),
                  torch.stack(gates, 1).reshape(El, groups * cap))
    ye = ye.reshape(El, groups, cap, D)
    return torch.cat([_combine(ye[:, g], slot_of[g])
                      for g in range(groups)])


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
    (:func:`_routed`) unless ``no_drop`` or T does not divide.
    """
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    factor = capacity_override or cfg.capacity_factor
    G = _groups()
    grouped = G > 1 and not no_drop and T % G == 0
    routed = _routed_on_shards if sharding._current_mesh() is not None \
        else _routed
    y = routed(cfg, p, xt, factor, G if grouped else 1, no_drop=no_drop,
               grouped=grouped)
    if cfg.num_shared_experts:
        y = y + _shared(cfg, p, xt)
    return sharding.shard(y.reshape(B, S, D), "batch", sharding.seq_axis(),
                          None)


def _routed_on_shards(cfg: ModelConfig, p: MoE, xt, factor: float,
                      groups: int, *, no_drop: bool, grouped: bool):
    """:func:`_routed` under a mesh, on each rank's shards
    (``sharding.on_shards``; DTensor has no strategy for the slotting's
    sort, search and scatters).  A rank routes and slots its batch rows'
    tokens, which are its groups' when the groups divide the batch shards
    (the default: one group a shard) and all it needs under ``no_drop``,
    else every token; it runs the experts it holds (its slice of the expert
    axis when the experts divide the model axis) on their slots and adds
    their outputs into its tokens' rows.  The result is a ``Partial`` sum
    over the model axis where the experts are split (DTensor's all-reduce
    or reduce-scatter completes it), and the FSDP-sharded expert weights
    are all-gathered over the data axes first.  Values are the one-device
    path's up to the order of the expert sums."""
    mesh = sharding._current_mesh()
    nb = sharding._axis_prod(mesh, sharding.physical_axes(mesh, "batch"))
    # a rank's own tokens where no capacity drops one, or where its groups
    # are whole; every token where the capacity is the whole batch's
    by_batch = no_drop or groups % nb == 0
    rows = sharding.spec(mesh, "batch" if by_batch else None, None,
                         shape=tuple(xt.shape))
    local_groups = groups // nb if rows[0] is not None and not no_drop \
        else groups
    experts = sharding.spec(mesh, "expert", None, None,
                            shape=tuple(p.e_gate.shape))
    by_experts = sharding.physical_axes(mesh, "expert") \
        if experts[0] is not None else None
    weights = (p.router, p.e_gate, p.e_up, p.e_down)
    specs = ((None, None), experts, experts, experts, rows)
    out = sharding.partial(by_experts, rows)
    # gradients: the weights' are partial over the ranks' token rows, the
    # router's and the tokens' also over the ranks' experts
    by_rows = rows[0] if isinstance(rows[0], tuple) else \
        ((rows[0],) if rows[0] else ())
    both = by_rows + (by_experts or ())
    grads = (sharding.partial(both, (None, None)),
             *(sharding.partial(by_rows, experts),) * 3,
             sharding.partial(by_experts, rows))

    def local(router, e_gate, e_up, e_down, xt_l):
        w = types.SimpleNamespace(router=router, e_gate=e_gate, e_up=e_up,
                                  e_down=e_down)
        e0 = sharding.coordinate(experts[0]) * e_gate.shape[0] \
            if by_experts else 0
        return _routed(cfg, w, xt_l, factor, local_groups, no_drop=no_drop,
                       grouped=grouped, e0=e0)

    return sharding.on_shards(local, (*weights, xt), specs, out, grads)
