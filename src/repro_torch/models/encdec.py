"""Encoder–decoder model (seamless-m4t backbone), the reference's
``repro.models.encdec``.

The audio frontend is a stub: callers feed precomputed frame embeddings
[B, S_src, frontend_dim], and a linear projection maps them into the
encoder width.  Encoder layers run bidirectional self-attention; decoder
layers causal self-attention then cross-attention.

:func:`encode_body`, :func:`forward_body` and :func:`loss_fn` are
differentiable; :func:`encode`, :func:`forward` and :func:`prefill` run
them for serving (``transformer.serving``), and
:func:`decode_step` is the decoder's (``transformer.decode_step``).
"""
from __future__ import annotations

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import sharding
from repro_torch.train.sharding import shard


def encode_body(cfg: ModelConfig, p: T.Model, frames):
    """frames [B, S_src, frontend_dim] -> enc_out [B, S_src, D]."""
    x = sharding.project("bsr,rd->bsd", L.cast(frames),
                         L.cast(p.frontend_proj), "frontend_proj")
    x = shard(x, "batch", None, None)
    x, _ = T.run_stack(cfg, p.encoder, x, T._positions(x),
                       n_layers=cfg.encoder_layers, causal=False)
    return L.rmsnorm(x, p.encoder_norm.scale, cfg.norm_eps)


def forward_body(cfg: ModelConfig, p: T.Model, tokens, frames, *,
                 collect_cache=False):
    """Teacher-forced decoder pass.  Returns (logits [B,St,V], caches)."""
    enc_out = encode_body(cfg, p, frames)
    x = T.embed(cfg, p, tokens)
    x, caches = T.run_stack(cfg, p.layers, x, T._positions(x), causal=True,
                            enc_out=enc_out, collect_cache=collect_cache)
    return T.unembed(cfg, p, x), caches


@T.serving
def encode(cfg: ModelConfig, p: T.Model, frames):
    """:func:`encode_body` for serving."""
    return encode_body(cfg, p, frames)


@T.serving
def forward(cfg: ModelConfig, p: T.Model, tokens, frames, *,
            collect_cache=False):
    """:func:`forward_body` for serving."""
    return forward_body(cfg, p, tokens, frames, collect_cache=collect_cache)


def loss_fn(cfg: ModelConfig, p: T.Model, batch: dict):
    """Next-token cross-entropy of the decoder (``transformer.head_loss``);
    labels == -1 masked.  ``batch``: tokens, labels [B,St], frontend
    [B,S_src,frontend_dim].  It honours ``flags.CHUNKED_LOSS`` as the
    decoder-only loss does (the reference's encoder-decoder loss is always
    unchunked; the two agree to f32 rounding)."""
    enc_out = encode_body(cfg, p, batch["frontend"])
    x = T.embed(cfg, p, batch["tokens"])
    h, _ = T.run_stack(cfg, p.layers, x, T._positions(x), causal=True,
                       enc_out=enc_out)
    return T.head_loss(cfg, p, h, batch["labels"])


@T.serving
def prefill(cfg: ModelConfig, p: T.Model, tokens, frames, max_seq: int):
    logits, caches = forward(cfg, p, tokens, frames, collect_cache=True)
    cache = sharding.shard_cache(T.init_cache(
        cfg, tokens.shape[0], max_seq, enc_len=frames.shape[1],
        device=logits.device))
    T._fill(cache, caches)
    for key in ("cross_k", "cross_v"):
        cache[key].copy_(caches[key])
    return logits[:, -1, :], cache


def decode_step(cfg: ModelConfig, p: T.Model, cache, token, pos):
    """One serving step of the decoder (the cache updated in place)."""
    return T.decode_step(cfg, p, cache, token, pos)
