"""Encoder–decoder model (seamless-m4t backbone), the reference's
``repro.models.encdec``.

The audio frontend is a stub: callers feed precomputed frame embeddings
[B, S_src, frontend_dim], and a linear projection maps them into the
encoder width.  Encoder layers run bidirectional self-attention; decoder
layers causal self-attention then cross-attention.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@torch.inference_mode()
def encode(cfg: ModelConfig, p: T.Model, frames):
    """frames [B, S_src, frontend_dim] -> enc_out [B, S_src, D]."""
    x = torch.einsum("bsr,rd->bsd", L.cast(frames), L.cast(p.frontend_proj))
    x, _ = T.run_stack(cfg, p.encoder, x, T._positions(x),
                       n_layers=cfg.encoder_layers, causal=False)
    return L.rmsnorm(x, p.encoder_norm.scale, cfg.norm_eps)


@torch.inference_mode()
def forward(cfg: ModelConfig, p: T.Model, tokens, frames, *,
            collect_cache=False):
    """Teacher-forced decoder pass.  Returns (logits [B,St,V], caches)."""
    enc_out = encode(cfg, p, frames)
    x = T.embed(cfg, p, tokens)
    x, caches = T.run_stack(cfg, p.layers, x, T._positions(x), causal=True,
                            enc_out=enc_out, collect_cache=collect_cache)
    return T.unembed(cfg, p, x), caches


@torch.inference_mode()
def prefill(cfg: ModelConfig, p: T.Model, tokens, frames, max_seq: int):
    logits, caches = forward(cfg, p, tokens, frames, collect_cache=True)
    cache = T.init_cache(cfg, tokens.shape[0], max_seq,
                         enc_len=frames.shape[1], device=logits.device)
    T._fill(cache, caches)
    for key in ("cross_k", "cross_v"):
        cache[key].copy_(caches[key])
    return logits[:, -1, :], cache


def decode_step(cfg: ModelConfig, p: T.Model, cache, token, pos):
    """One serving step of the decoder (the cache updated in place)."""
    return T.decode_step(cfg, p, cache, token, pos)
