"""Shared neural layers: norms, RoPE, GQA attention (windows / softcap /
prefix-LM / decode cache), gated MLPs.  The reference's
``repro.models.layers``.

Parameters live in ``nn.Module``s whose attribute names are the
reference's pytree keys (``Attention.wq`` is ``p["wq"]``); the layers are
plain functions of a config, a module and tensors.  Compute is in
``COMPUTE_DTYPE`` (bf16; a test may set the attribute), accumulation and
softmax in f32, op for op as the reference:

* an einsum of ``COMPUTE_DTYPE`` operands without ``preferred_element_type``
  returns ``COMPUTE_DTYPE`` (its product accumulates in f32 and is rounded
  once, as XLA's does);
* an einsum that the reference asks for ``preferred_element_type=f32`` is
  the f32 product of the operands' values (``_dot32``);
* the mask value is -1e30 and the softmax runs in f32.

The reference's switches are read from :mod:`flags` when a function
runs: ``ROPE_BF16`` (RoPE arithmetic in bf16), ``ATTN_BF16_SOFTMAX`` (the
logits and softmax in bf16) and ``BLOCKWISE_ATTN`` (an online softmax over
KV blocks, :func:`attention_core_blockwise`); their defaults are f32 and
materialized logits.  Every function here is differentiable: the one
in-place op, the mask written into the f32 logits, acts on a tensor that
no backward reads.

Attention is the reference's einsum -> mask -> softmax -> einsum, not
``scaled_dot_product_attention``, which has no softcap or prefix mask and
associates differently.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import flags
from repro_torch.models.config import ModelConfig

COMPUTE_DTYPE = torch.bfloat16
_NEG = -1e30


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def _dot32(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``einsum(..., preferred_element_type=f32)``: the f32 product of the
    operands' values (exact for bf16 operands)."""
    return torch.einsum(equation, *(o.float() for o in operands))


def param(gen, shape, scale, *, device, dtype) -> nn.Parameter:
    """A frozen parameter drawn from N(0, 1) * ``scale`` on ``gen`` (the
    train step differentiates copies of it)."""
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return nn.Parameter(t.mul_(scale), requires_grad=False)


def const(shape, value, *, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, device=device, dtype=dtype),
                        requires_grad=False)


class Norm(nn.Module):
    """An RMSNorm's ``scale`` (zeros: the norm multiplies by 1 + scale)."""

    def __init__(self, dim: int, *, device, dtype):
        super().__init__()
        self.scale = const((dim,), 0.0, device=device, dtype=dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope(x, positions, theta: float):
    """x [..., S, H, hd], positions [..., S] -> same shape."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                 # [..., S, half]
    cdt = COMPUTE_DTYPE if flags.ROPE_BF16 else torch.float32
    cos = torch.cos(ang)[..., None, :].to(cdt)                 # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :].to(cdt)
    x1, x2 = torch.chunk(x.to(cdt), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """wq [D, H, hd], wk / wv [D, KV, hd], wo [H, hd, D]; q_norm / k_norm
    under qk-norm (qwen3)."""

    def __init__(self, cfg: ModelConfig, gen, *, device, dtype):
        super().__init__()
        D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        sc = D ** -0.5
        kw = dict(device=device, dtype=dtype)
        self.wq = param(gen, (D, H, hd), sc, **kw)
        self.wk = param(gen, (D, KV, hd), sc, **kw)
        self.wv = param(gen, (D, KV, hd), sc, **kw)
        self.wo = param(gen, (H, hd, D), (H * hd) ** -0.5, **kw)
        if cfg.qk_norm:
            self.q_norm = Norm(hd, **kw)
            self.k_norm = Norm(hd, **kw)


def _attn_mask(q_pos, kv_pos, *, causal, window, prefix_len, kv_valid):
    """[..., Sq, Skv] boolean mask."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    if causal:
        mask = kp <= qp
    else:
        mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                          dtype=torch.bool, device=qp.device)
    if window is not None:
        mask = mask & (qp - kp < window)
    if prefix_len is not None:
        mask = mask | ((qp < prefix_len) & (kp < prefix_len))
    if kv_valid is not None:
        mask = mask & kv_valid[..., None, :]
    return mask


def attention_core_blockwise(cfg: ModelConfig, q, k, v, q_pos, kv_pos, *,
                             causal, window, prefix_len, block: int):
    """Flash-style attention: an online softmax over KV blocks of
    ``block`` keys, in order; the [Sq, Skv] logits never exist whole (each
    step holds [.., Sq, block]).  Differentiable (autograd through the
    loop); each block's mask is rebuilt from the positions, padded keys at
    position -10**9 and invalid."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    if Skv % block:
        pad = block - Skv % block
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-10 ** 9)
        Skv += pad
    qg = cast(q.reshape(B, Sq, KV, G, hd))
    scale = hd ** -0.5
    m = torch.full((B, KV, G, Sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(0, Skv, block):
        k_j, v_j, p_j = k[:, j:j + block], v[:, j:j + block], \
            kv_pos[..., j:j + block]
        logits = _dot32("bqkgd,bskd->bkgqs", qg, cast(k_j)) * scale
        if cfg.attn_softcap:
            c = cfg.attn_softcap
            logits = c * torch.tanh(logits / c)
        mask = _attn_mask(q_pos, p_j, causal=causal, window=window,
                          prefix_len=prefix_len, kv_valid=p_j >= 0)
        # mask [B?,Sq,block] -> [B,1,1,Sq,block]
        mask = mask[:, None, None] if mask.ndim == 3 \
            else mask[None, None, None]
        logits = torch.where(mask, logits, _NEG)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + _dot32("bkgqs,bskd->bkgqd",
                                             p.to(COMPUTE_DTYPE), cast(v_j))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]       # [B,KV,G,Sq,hd]
    out = torch.movedim(out, 3, 1).reshape(B, Sq, H, hd)
    return out.to(COMPUTE_DTYPE)


def attention_core(cfg: ModelConfig, q, k, v, mask):
    """q [B,Sq,H,hd]; k,v [B,Skv,KV,hd]; mask [B?,Sq,Skv] -> [B,Sq,H,hd]."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    if flags.ATTN_BF16_SOFTMAX:
        # the scale folded into Q; the logits / softmax chain stays bf16
        # (the row max subtracted, outside the gradient)
        qg = cast(qg) * torch.tensor(hd ** -0.5, dtype=COMPUTE_DTYPE)
        logits = torch.einsum("bqkgd,bskd->bkgqs", cast(qg), cast(k))
        if cfg.attn_softcap:
            c = cfg.attn_softcap
            logits = (c * torch.tanh(logits / c)).to(COMPUTE_DTYPE)
        while mask.ndim < logits.ndim:
            mask = mask[:, None]
        neg = torch.tensor(-3e38, dtype=COMPUTE_DTYPE, device=q.device)
        logits = torch.where(mask, logits, neg)
        mx = torch.amax(logits, dim=-1, keepdim=True).detach()
        p = torch.exp(logits - mx)
        w = p / torch.sum(p, dim=-1, keepdim=True)
        out = _dot32("bkgqs,bskd->bqkgd", w, cast(v))
        return out.reshape(B, Sq, H, hd).to(COMPUTE_DTYPE)
    logits = _dot32("bqkgd,bskd->bkgqs", cast(qg), cast(k)) * (hd ** -0.5)
    if cfg.attn_softcap:
        c = cfg.attn_softcap
        logits = c * torch.tanh(logits / c)
    while mask.ndim < logits.ndim:
        mask = mask[:, None]
    w = torch.softmax(logits.masked_fill_(~mask, _NEG), dim=-1)
    del logits
    out = _dot32("bkgqs,bskd->bqkgd", cast(w), cast(v))
    return out.reshape(B, Sq, H, hd).to(COMPUTE_DTYPE)


def _project_qkv(cfg, p: Attention, x):
    q = torch.einsum("bsd,dhk->bshk", cast(x), cast(p.wq))
    k = torch.einsum("bsd,dhk->bshk", cast(x), cast(p.wk))
    v = torch.einsum("bsd,dhk->bshk", cast(x), cast(p.wv))
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm.scale, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm.scale, cfg.norm_eps)
    return q, k, v


def self_attention(cfg: ModelConfig, p: Attention, x, positions, *,
                   causal: bool = True, window=None, prefix_len=None):
    """Full-sequence self-attention (train / prefill).  Returns (out,
    (k, v)); blockwise under ``flags.BLOCKWISE_ATTN`` when the sequence is
    longer than a block."""
    q, k, v = _project_qkv(cfg, p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    block = flags.BLOCKWISE_ATTN
    if block and q.shape[1] > block:
        out = attention_core_blockwise(
            cfg, q, k, v, positions, positions, causal=causal, window=window,
            prefix_len=prefix_len, block=block)
    else:
        mask = _attn_mask(positions, positions, causal=causal, window=window,
                          prefix_len=prefix_len, kv_valid=None)
        out = attention_core(cfg, q, k, v, mask)
    out = torch.einsum("bshk,hkd->bsd", cast(out), cast(p.wo))
    return out, (k, v)


def self_attention_decode(cfg: ModelConfig, p: Attention, x, k_cache, v_cache,
                          pos: int, *, window=None):
    """Single-token decode against a KV cache.

    x [B,1,D]; k_cache / v_cache [B,Smax,KV,hd]; ``pos`` the current index.
    The new key and value are written into the caches in place (the
    reference's ``dynamic_update_slice``, same values).  Returns
    (out [B,1,D], k_cache, v_cache).
    """
    B, Smax = k_cache.shape[0], k_cache.shape[1]
    pos = int(pos)
    q, k_new, v_new = _project_qkv(cfg, p, x)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k_new = rope(k_new, posv, cfg.rope_theta)
    k_cache[:, pos:pos + 1] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + 1] = v_new.to(v_cache.dtype)
    kv_pos = torch.arange(Smax, device=x.device)[None, :]
    mask = _attn_mask(posv, kv_pos, causal=True, window=window,
                      prefix_len=None, kv_valid=kv_pos <= pos)
    out = attention_core(cfg, q, k_cache, v_cache, mask)
    out = torch.einsum("bshk,hkd->bsd", cast(out), cast(p.wo))
    return out, k_cache, v_cache


def cross_attention(cfg: ModelConfig, p: Attention, x, k_enc, v_enc):
    """Decoder cross-attention to precomputed encoder K/V (no positions)."""
    q = torch.einsum("bsd,dhk->bshk", cast(x), cast(p.wq))
    Skv = k_enc.shape[1]
    mask = torch.ones((1, x.shape[1], Skv), dtype=torch.bool, device=x.device)
    out = attention_core(cfg, q, k_enc, v_enc, mask)
    return torch.einsum("bshk,hkd->bsd", cast(out), cast(p.wo))


def encode_kv(cfg: ModelConfig, p: Attention, enc_out):
    k = torch.einsum("bsd,dhk->bshk", cast(enc_out), cast(p.wk))
    v = torch.einsum("bsd,dhk->bshk", cast(enc_out), cast(p.wv))
    return k, v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """w_up [D, F], w_down [F, D], and w_gate [D, F] when gated."""

    def __init__(self, d_model: int, d_ff: int, gated: bool, gen, *, device,
                 dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.w_up = param(gen, (d_model, d_ff), d_model ** -0.5, **kw)
        self.w_down = param(gen, (d_ff, d_model), d_ff ** -0.5, **kw)
        if gated:
            self.w_gate = param(gen, (d_model, d_ff), d_model ** -0.5, **kw)


def init_mlp(cfg: ModelConfig, gen, d_ff: int | None = None, *, device,
             dtype) -> MLP:
    return MLP(cfg.d_model, cfg.d_ff if d_ff is None else d_ff,
               cfg.mlp in ("swiglu", "geglu"), gen, device=device, dtype=dtype)


def mlp(cfg: ModelConfig, p: MLP, x):
    up = torch.einsum("bsd,df->bsf", cast(x), cast(p.w_up))
    if cfg.mlp == "swiglu":
        gate = torch.einsum("bsd,df->bsf", cast(x), cast(p.w_gate))
        h = F.silu(gate) * up
    elif cfg.mlp == "geglu":
        gate = torch.einsum("bsd,df->bsf", cast(x), cast(p.w_gate))
        h = F.gelu(gate, approximate="tanh") * up
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(up))
    else:
        raise ValueError(cfg.mlp)
    return torch.einsum("bsf,fd->bsd", h, cast(p.w_down))
