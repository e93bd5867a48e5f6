"""Unified decoder stack for all assigned families, the reference's
``repro.models.transformer``: forward, loss, prefill and decode.

The stack is an ``nn.ModuleList`` of per-layer :class:`Block`s, run in
order; layer heterogeneity (hymba's 3 global layers among sliding-window
ones) is the per-layer window of :func:`window_schedule`, as in the
reference's scanned window vector.  The encoder-decoder (seamless) reuses
the same blocks in ``encdec.py``.

Public functions take the config, the :class:`Model` and tensors.
:func:`forward_body`, :func:`loss_fn` and :func:`_nll` are differentiable
(autograd reaches every parameter); :func:`forward`, :func:`prefill` and
:func:`decode_step`, the serving path, run under ``torch.inference_mode()``
(``forward`` is ``forward_body`` there: the same ops, the same bits;
under a mesh, where DTensors need version counters, they run under
``torch.no_grad()`` instead: :func:`serving`).
Under autograd :func:`run_stack` recomputes each layer in the backward as
``flags.REMAT_POLICY`` says (the reference's per-layer ``jax.checkpoint``);
remat changes what is kept, never a value.  The decode cache is a dict of
tensors stacked by layer, in the reference's layout; :func:`decode_step`
writes each layer's slice in place and returns the same dict.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import device as devices
from repro_torch.models import flags
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.train import sharding
from repro_torch.train.sharding import seq_axis, shard

FULL_WINDOW = 1 << 30


def serving(fn):
    """``fn`` under ``torch.inference_mode()``, or under a mesh (DTensors
    keep version counters) ``torch.no_grad()``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.no_grad(), \
                torch.inference_mode(sharding._current_mesh() is None):
            return fn(*args, **kwargs)

    return run


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
class Block(nn.Module):
    """One layer's parameters, named as the reference's stacked pytree."""

    def __init__(self, cfg: ModelConfig, gen, *, cross: bool = False,
                 causal_family: str | None = None, device, dtype):
        super().__init__()
        fam = causal_family or cfg.family
        D = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.ln1 = L.Norm(D, **kw)
        if fam == "ssm":
            self.ssm = ssm_mod.init_ssm(cfg, gen, **kw)
            return
        self.attn = L.Attention(cfg, gen, **kw)
        self.ln2 = L.Norm(D, **kw)
        if cfg.sandwich_norm:
            self.post_attn_ln = L.Norm(D, **kw)
            self.post_mlp_ln = L.Norm(D, **kw)
        if fam == "hybrid":
            self.ssm = ssm_mod.init_ssm(cfg, gen, **kw)
        if cfg.moe and fam == "moe":
            self.moe = moe_mod.init_moe(cfg, gen, **kw)
        else:
            self.mlp = L.init_mlp(cfg, gen, **kw)
        if cross:
            self.cross = L.Attention(cfg, gen, **kw)
            self.ln_cross = L.Norm(D, **kw)


def init_layer_stack(cfg: ModelConfig, gen, n_layers: int, *,
                     cross: bool = False, causal_family: str | None = None,
                     device, dtype=torch.float32) -> nn.ModuleList:
    return nn.ModuleList(
        Block(cfg, gen, cross=cross, causal_family=causal_family,
              device=device, dtype=dtype) for _ in range(n_layers))


class Model(nn.Module):
    """embedding [V, D], layers, final_norm; lm_head [D, V] when untied,
    frontend_proj [F, D] with a frontend, encoder and encoder_norm for the
    encoder-decoder."""

    def __init__(self, cfg: ModelConfig, gen, *, device, dtype):
        super().__init__()
        D, V = cfg.d_model, cfg.vocab_size
        kw = dict(device=device, dtype=dtype)
        self.embedding = L.param(gen, (V, D), D ** -0.5, **kw)
        self.layers = init_layer_stack(cfg, gen, cfg.num_layers,
                                       cross=cfg.cross_attention, **kw)
        self.final_norm = L.Norm(D, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = L.param(gen, (D, V), D ** -0.5, **kw)
        if cfg.frontend:
            self.frontend_proj = L.param(gen, (cfg.frontend_dim, D),
                                         cfg.frontend_dim ** -0.5, **kw)
        if cfg.encoder_layers:
            self.encoder = init_layer_stack(cfg, gen, cfg.encoder_layers,
                                            causal_family="dense", **kw)
            self.encoder_norm = L.Norm(D, **kw)


def init_params(cfg: ModelConfig, generator, *, device=None,
                dtype=torch.float32) -> Model:
    """A :class:`Model` with the reference's shapes and scales drawn from
    ``generator`` (a ``torch.Generator`` on ``device``, or an int seed for
    one).  The values are not ``jax.random``'s: weights cross between the
    packages through ``repro_torch.convert.model_params_from_numpy``.
    Its parameters are frozen: the train step differentiates copies of
    them.  Runs on the card unless ``device="cpu"``."""
    dev = devices.resolve(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    return Model(cfg, generator, device=dev, dtype=dtype)


def abstract_params(cfg: ModelConfig, dtype=torch.float32) -> Model:
    """A :class:`Model` on the ``meta`` device: the shapes and dtypes of
    :func:`init_params`' parameters, no storage and no draws (the dry
    run's input; the reference's ``ShapeDtypeStruct`` pytree)."""
    return Model(cfg, None, device=torch.device("meta"), dtype=dtype)


# ---------------------------------------------------------------------------
# Layer schedule
# ---------------------------------------------------------------------------
def window_schedule(cfg: ModelConfig, n_layers: int) -> list[int]:
    if cfg.layer_pattern == "local_global" and cfg.window:
        # gemma2: even layers local (sliding window), odd layers global
        return [cfg.window if i % 2 == 0 else FULL_WINDOW
                for i in range(n_layers)]
    if cfg.layer_pattern == "mostly_local" and cfg.window:
        # hymba: first / middle / last layers global, rest sliding window
        glob = {0, n_layers // 2, n_layers - 1}
        return [FULL_WINDOW if i in glob else cfg.window
                for i in range(n_layers)]
    return [FULL_WINDOW] * n_layers


def _stack(caches: list) -> dict:
    """Per-layer cache dicts -> one dict of tensors stacked by layer."""
    out = {}
    for key, first in caches[0].items():
        parts = [c[key] for c in caches]
        out[key] = _stack(parts) if isinstance(first, dict) \
            else torch.stack(parts)
    return out


# ---------------------------------------------------------------------------
# Blocks (full sequence)
# ---------------------------------------------------------------------------
def block_full(cfg: ModelConfig, lp: Block, x, positions, window, *,
               causal=True, prefix_len=None, enc_out=None):
    """One decoder layer over the full sequence.  Returns (x, cache_entry)."""
    cache = {}
    if cfg.family == "ssm":
        h = L.rmsnorm(x, lp.ln1.scale, cfg.norm_eps)
        out, cache["ssm"] = ssm_mod.ssd_full(cfg, lp.ssm, h)
        return x + out, cache

    h = L.rmsnorm(x, lp.ln1.scale, cfg.norm_eps)
    attn_out, (k, v) = L.self_attention(
        cfg, lp.attn, h, positions,
        causal=causal, window=window, prefix_len=prefix_len)
    cache["k"], cache["v"] = k, v
    if cfg.family == "hybrid":
        ssm_out, cache["ssm"] = ssm_mod.ssd_full(cfg, lp.ssm, h)
        attn_out = (attn_out + ssm_out) * 0.5      # hymba mean fusion
    if cfg.sandwich_norm:
        attn_out = L.rmsnorm(attn_out, lp.post_attn_ln.scale, cfg.norm_eps)
    x = x + attn_out

    if enc_out is not None:
        h = L.rmsnorm(x, lp.ln_cross.scale, cfg.norm_eps)
        k_enc, v_enc = L.encode_kv(cfg, lp.cross, enc_out)
        cache["cross_k"], cache["cross_v"] = k_enc, v_enc
        x = x + L.cross_attention(cfg, lp.cross, h, k_enc, v_enc)

    h = L.rmsnorm(x, lp.ln2.scale, cfg.norm_eps)
    if cfg.moe and cfg.family == "moe":
        mlp_out = moe_mod.moe_ffn(cfg, lp.moe, h)
    else:
        mlp_out = L.mlp(cfg, lp.mlp, h)
    if cfg.sandwich_norm:
        mlp_out = L.rmsnorm(mlp_out, lp.post_mlp_ln.scale, cfg.norm_eps)
    return x + mlp_out, cache


def _save_projections(ctx, op, *args, **kwargs):
    """``REMAT_POLICY="dots"``: keep the outputs of the products with no
    batch dims (the weight projections; ``torch.einsum`` runs them as
    ``bmm`` with a batch of 1, or ``mm``) and recompute the rest (the
    batched attention, SSD and expert products among them), the
    reference's ``dots_with_no_batch_dims_saveable``."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn):
    """``fn`` recomputed in the backward as ``flags.REMAT_POLICY`` says
    ("full": all of it; "dots": all but the weight projections; None: not
    at all); ``fn`` itself where autograd records nothing."""
    policy = flags.REMAT_POLICY
    if policy is None or not torch.is_grad_enabled():
        return fn
    if policy == "full":
        kw = {}
    elif policy == "dots":
        kw = dict(context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_projections))
    else:
        raise ValueError(f"REMAT_POLICY {policy!r}: 'full', 'dots' or None")
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def run_stack(cfg: ModelConfig, p_layers, x, positions, *, n_layers=None,
              causal=True, prefix_len=None, enc_out=None,
              collect_cache=False):
    n_layers = n_layers or cfg.num_layers
    if len(p_layers) != n_layers:
        raise ValueError(f"{len(p_layers)} layers, config says {n_layers}")
    caches = []
    for lp, w_l in zip(p_layers, window_schedule(cfg, n_layers)):
        def layer(x, lp=lp, w_l=w_l):
            out, cache = block_full(cfg, lp, x, positions, w_l,
                                    causal=causal, prefix_len=prefix_len,
                                    enc_out=enc_out)
            return (out, cache) if collect_cache else (out, None)

        x, cache = remat(layer)(x)
        if collect_cache:
            caches.append(cache)
    return x, (_stack(caches) if collect_cache else None)


# ---------------------------------------------------------------------------
# Blocks (single-token decode vs cache)
# ---------------------------------------------------------------------------
def block_decode(cfg: ModelConfig, lp: Block, x, cache, pos, window):
    new_cache = {}
    if cfg.family == "ssm":
        h = L.rmsnorm(x, lp.ln1.scale, cfg.norm_eps)
        out, new_cache["ssm"] = ssm_mod.ssd_decode(cfg, lp.ssm, h,
                                                   cache["ssm"])
        return x + out, new_cache

    h = L.rmsnorm(x, lp.ln1.scale, cfg.norm_eps)
    attn_out, new_cache["k"], new_cache["v"] = L.self_attention_decode(
        cfg, lp.attn, h, cache["k"], cache["v"], pos, window=window)
    if cfg.family == "hybrid":
        ssm_out, new_cache["ssm"] = ssm_mod.ssd_decode(
            cfg, lp.ssm, h, cache["ssm"])
        attn_out = (attn_out + ssm_out) * 0.5
    if cfg.sandwich_norm:
        attn_out = L.rmsnorm(attn_out, lp.post_attn_ln.scale, cfg.norm_eps)
    x = x + attn_out

    if "cross_k" in cache:
        h = L.rmsnorm(x, lp.ln_cross.scale, cfg.norm_eps)
        x = x + L.cross_attention(cfg, lp.cross, h, cache["cross_k"],
                                  cache["cross_v"])
        new_cache["cross_k"] = cache["cross_k"]
        new_cache["cross_v"] = cache["cross_v"]

    h = L.rmsnorm(x, lp.ln2.scale, cfg.norm_eps)
    if cfg.moe and cfg.family == "moe":
        # SERVE_MOE_CAP unset: capacity T, no decoded token dropped
        cap = flags.SERVE_MOE_CAP
        mlp_out = moe_mod.moe_ffn(cfg, lp.moe, h, **(
            dict(no_drop=True) if cap is None
            else dict(capacity_override=cap)))
    else:
        mlp_out = L.mlp(cfg, lp.mlp, h)
    if cfg.sandwich_norm:
        mlp_out = L.rmsnorm(mlp_out, lp.post_mlp_ln.scale, cfg.norm_eps)
    return x + mlp_out, new_cache


def _layer(caches: dict, i: int) -> dict:
    """Layer ``i``'s slice of a stacked cache (views)."""
    return {key: _layer(val, i) if isinstance(val, dict) else val[i]
            for key, val in caches.items()}


def _write(views: dict, new: dict) -> None:
    """Copy a layer's new cache entries into its slice, where they are not
    that slice already (the KV caches are written in place)."""
    for key, val in new.items():
        if isinstance(val, dict):
            _write(views[key], val)
        elif val is not views[key]:
            views[key].copy_(val)


def run_stack_decode(cfg: ModelConfig, p_layers, x, caches, pos, *,
                     n_layers=None):
    n_layers = n_layers or cfg.num_layers
    for i, (lp, w_l) in enumerate(zip(p_layers,
                                      window_schedule(cfg, n_layers))):
        views = _layer(caches, i)
        x, new_cache = block_decode(cfg, lp, x, views, pos, w_l)
        _write(views, new_cache)
    return x, caches


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def _lookup(w, tokens):
    """``w[tokens]``; under a mesh on each rank's shards, vocabulary
    parallel: a rank looks up its batch rows' tokens in its slice of the
    vocabulary (the model axis where that splits the rows), zeros for the
    others, so the rows are a partial sum over that axis; the FSDP-split
    width is gathered first.  (DTensor's strategy for the lookup's
    backward, an ``index_put``, fails on some torch versions.)"""
    mesh = sharding._current_mesh()
    if mesh is None:
        return w[tokens]
    ws = sharding.spec(mesh, "model", None, shape=tuple(w.shape))
    ts = sharding.spec(mesh, "batch", *(None,) * (tokens.ndim - 1),
                       shape=tuple(tokens.shape))
    V = w.shape[0]

    def local(wl, tl):
        if wl.shape[0] == V:
            return wl[tl]
        v0 = sharding.coordinate(ws[0]) * wl.shape[0]
        mine = (tl >= v0) & (tl < v0 + wl.shape[0])
        rows = wl[torch.where(mine, tl - v0, 0)]
        return torch.where(mine[..., None], rows, 0.0)

    return sharding.on_shards(
        local, (w, tokens), (ws, ts),
        sharding.partial(ws[0], (*ts, None)),
        (sharding.partial(ts[0], ws), ts))


def embed(cfg: ModelConfig, p: Model, tokens):
    e = _lookup(p.embedding, tokens)
    if cfg.scale_embedding:
        e = e * torch.sqrt(torch.tensor(float(cfg.d_model))).to(e.dtype)
    return shard(L.cast(e), "batch", seq_axis(), None)


def unembed(cfg: ModelConfig, p: Model, h):
    h = L.rmsnorm(h, p.final_norm.scale, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = sharding.project("bsd,vd->bsv", L.cast(h).float(),
                                  L.cast(p.embedding).float(), "embedding")
    else:
        logits = sharding.project("bsd,dv->bsv", L.cast(h).float(),
                                  L.cast(p.lm_head).float(), "lm_head")
    if cfg.final_softcap:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return shard(logits, "batch", None, "model")


def _prefix_inputs(cfg: ModelConfig, p: Model, tokens, frontend):
    """VLM: project stub patch embeddings and prepend to token embeddings."""
    x_txt = embed(cfg, p, tokens)
    if frontend is None:
        return x_txt, None
    proj = sharding.project("bpr,rd->bpd", L.cast(frontend),
                            L.cast(p.frontend_proj), "frontend_proj")
    return shard(torch.cat([proj, x_txt], dim=1), "batch", None, None), \
        cfg.frontend_len


def _positions(x):
    B, S = x.shape[0], x.shape[1]
    return torch.arange(S, dtype=torch.int32, device=x.device)[None, :] \
        .expand(B, S)


# ---------------------------------------------------------------------------
# Public model functions (decoder-only families)
# ---------------------------------------------------------------------------
def forward_body(cfg: ModelConfig, p: Model, tokens, *, frontend=None,
                 collect_cache=False):
    """Full-sequence forward, differentiable.  tokens [B,St]; frontend
    [B,Lf,raw] for VLM.

    Returns (logits [B,S,V] f32, caches stacked by layer or None).  For
    VLM, S = Lf + St.
    """
    x, prefix_len = _prefix_inputs(cfg, p, tokens, frontend)
    x, caches = run_stack(cfg, p.layers, x, _positions(x),
                          prefix_len=prefix_len, collect_cache=collect_cache)
    return unembed(cfg, p, x), caches


@serving
def forward(cfg: ModelConfig, p: Model, tokens, *, frontend=None,
            collect_cache=False):
    """:func:`forward_body` for serving (``torch.inference_mode()``)."""
    return forward_body(cfg, p, tokens, frontend=frontend,
                        collect_cache=collect_cache)


def _nll(logits, labels):
    """(sum of the next-token NLL over labels >= 0, their count)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels >= 0
    safe = torch.clamp_min(labels, 0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(torch.where(valid, nll, 0.0)), torch.sum(valid)


def _chunk_nll(cfg: ModelConfig, p: Model, h, labels):
    return _nll(unembed(cfg, p, h), labels)


def head_loss(cfg: ModelConfig, p: Model, h, labels):
    """Mean next-token NLL of the stack's output ``h`` [B,S,D] over
    ``labels`` >= 0.  Under ``flags.CHUNKED_LOSS`` the logits are made per
    sequence chunk (the sequence padded with label -1), each chunk
    recomputed in the backward, and the chunks' sums added in chunk
    order."""
    c = flags.CHUNKED_LOSS
    if not c:
        tot, cnt = _chunk_nll(cfg, p, h, labels)
        return tot / torch.clamp_min(cnt, 1)
    S = h.shape[1]
    pad_s = (-S) % c
    if pad_s:
        h = F.pad(h, (0, 0, 0, pad_s))
        labels = F.pad(labels, (0, pad_s), value=-1)
    chunk = functools.partial(_chunk_nll, cfg, p)
    if torch.is_grad_enabled():
        chunk = functools.partial(ckpt.checkpoint, chunk, use_reentrant=False)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for j in range(0, S + pad_s, c):
        s_j, n_j = chunk(h[:, j:j + c], labels[:, j:j + c])
        tot, cnt = tot + s_j, cnt + n_j
    return tot / torch.clamp_min(cnt, 1)


def loss_fn(cfg: ModelConfig, p: Model, batch: dict):
    """Next-token cross-entropy (:func:`head_loss`); labels == -1 are
    masked, the VLM's image prefix among them.  ``batch``: tokens [B,St],
    labels [B,St] and, for VLM, frontend [B,Lf,raw]."""
    labels = batch["labels"]
    frontend = batch.get("frontend")
    if cfg.frontend and frontend is not None:
        pad = torch.full((labels.shape[0], cfg.frontend_len), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    x, prefix_len = _prefix_inputs(cfg, p, batch["tokens"], frontend)
    h, _ = run_stack(cfg, p.layers, x, _positions(x), prefix_len=prefix_len)
    return head_loss(cfg, p, h, labels)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               enc_len: int | None = None, dtype=torch.bfloat16,
               device=None) -> dict:
    """Stacked-by-layer decode cache of zeros (the reference's layout)."""
    dev = devices.resolve(device)
    return _cache(cfg, batch, max_seq, enc_len=enc_len, dtype=dtype,
                  device=dev)


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int, **kw) -> dict:
    """:func:`init_cache`'s dict as ``meta`` tensors (no storage)."""
    return _cache(cfg, batch, max_seq, **kw, device=torch.device("meta"))


def _cache(cfg: ModelConfig, batch: int, max_seq: int, *,
           enc_len: int | None = None, dtype=torch.bfloat16,
           device: torch.device) -> dict:
    Lc, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cache: dict = {}
    if cfg.family != "ssm":
        for key in ("k", "v"):
            cache[key] = torch.zeros((Lc, batch, max_seq, KV, hd),
                                     dtype=dtype, device=device)
    if cfg.family in ("ssm", "hybrid"):
        one = ssm_mod.init_ssm_cache(cfg, batch, device=device)
        cache["ssm"] = {key: torch.zeros((Lc,) + a.shape, dtype=a.dtype,
                                         device=device)
                        for key, a in one.items()}
    if cfg.cross_attention and enc_len:
        for key in ("cross_k", "cross_v"):
            cache[key] = torch.zeros((Lc, batch, enc_len, KV, hd),
                                     dtype=dtype, device=device)
    return cache


@serving
def decode_step(cfg: ModelConfig, p: Model, cache, token, pos):
    """One serving step: token [B,1], ``pos`` the position it takes.

    Returns (logits [B,V] f32, cache); the cache is updated in place."""
    x = embed(cfg, p, token)
    x, cache = run_stack_decode(cfg, p.layers, x, cache, pos)
    return unembed(cfg, p, x)[:, 0, :], cache


def _fill(cache: dict, caches: dict) -> None:
    """Copy a prefill's stacked caches into the padded decode cache."""
    for key in ("k", "v"):
        if key in cache:
            n, S = caches[key].shape[2], cache[key].shape[2]
            if n == S:
                cache[key].copy_(caches[key])
            elif sharding._current_mesh() is not None:
                # a slice of a split sequence is a copy, not a view: the
                # prompt's entries padded to the cache's length instead
                cache[key].copy_(F.pad(caches[key], (0, 0, 0, 0, 0, S - n)))
            else:
                cache[key][:, :, :n].copy_(caches[key])
    if "ssm" in cache:
        for key, z in cache["ssm"].items():
            z.copy_(caches["ssm"][key])


@serving
def prefill(cfg: ModelConfig, p: Model, tokens, max_seq: int, *,
            frontend=None):
    """Process the prompt, build the decode cache padded to max_seq.

    Returns (last-position logits [B,V], cache)."""
    logits, caches = forward(cfg, p, tokens, frontend=frontend,
                             collect_cache=True)
    cache = sharding.shard_cache(
        init_cache(cfg, tokens.shape[0], max_seq, device=logits.device))
    _fill(cache, caches)
    return logits[:, -1, :], cache
