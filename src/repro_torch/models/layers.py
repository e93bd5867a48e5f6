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
from repro_torch.train import sharding
from repro_torch.train.sharding import project, seq_axis, shard

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
    m = torch.full((B, KV, G, Sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(0, Skv, block):
        k_j, v_j, p_j = k[:, j:j + block], v[:, j:j + block], \
            kv_pos[..., j:j + block]
        mask = _attn_mask(q_pos, p_j, causal=causal, window=window,
                          prefix_len=prefix_len, kv_valid=p_j >= 0)
        logits = _scores(cfg, qg, k_j, mask, bf16=False)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        corr = torch.exp(m - m_new)
        l_j, acc_j = _exp_sums(logits, m_new, v_j)
        l = l * corr + l_j
        acc = acc * corr[..., None] + acc_j
        m = m_new
    return _normalized(acc, l)


def _scores(cfg: ModelConfig, qg, k, mask, *, bf16: bool):
    """The masked logits [B,KV,G,Sq,Skv] of the grouped queries ``qg``
    [B,Sq,KV,G,hd] against ``k`` [B,Skv,KV,hd], scaled and soft-capped: in
    f32, or under ``bf16`` (``flags.ATTN_BF16_SOFTMAX``) in bf16 with the
    scale folded into Q.  ``mask`` is [B?,Sq,Skv]; masked logits are a
    large negative number."""
    hd = qg.shape[-1]
    if bf16:
        qg = cast(qg) * torch.tensor(hd ** -0.5, dtype=COMPUTE_DTYPE)
        logits = torch.einsum("bqkgd,bskd->bkgqs", cast(qg), cast(k))
        neg = -3e38
    else:
        logits = _dot32("bqkgd,bskd->bkgqs", cast(qg), cast(k)) * (hd ** -0.5)
        neg = _NEG
    if cfg.attn_softcap:
        c = cfg.attn_softcap
        logits = (c * torch.tanh(logits / c)).to(logits.dtype)
    if mask.ndim == 2:
        mask = mask[None]
    while mask.ndim < logits.ndim:
        mask = mask[:, None]
    return logits.masked_fill_(~mask, neg)


def _exp_sums(logits, m, v):
    """The softmax's sums against the row max ``m`` [B,KV,G,Sq]: (sum of
    exp(logits - m) [B,KV,G,Sq], those weights times ``v`` [B,KV,G,Sq,hd]
    in f32)."""
    p = torch.exp(logits - m[..., None])
    return (torch.sum(p, dim=-1).float(),
            _dot32("bkgqs,bskd->bkgqd", p.to(COMPUTE_DTYPE), cast(v)))


def _normalized(acc, l):
    """[B,Sq,H,hd] attention output from the weighted values ``acc``
    [B,KV,G,Sq,hd] and the weights' sums ``l``."""
    B, KV, G, Sq, hd = acc.shape
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = torch.movedim(out, 3, 1).reshape(B, Sq, KV * G, hd)
    return out.to(COMPUTE_DTYPE)


def attention_core(cfg: ModelConfig, q, k, v, mask):
    """q [B,Sq,H,hd]; k,v [B,Skv,KV,hd]; mask [B?,Sq,Skv] -> [B,Sq,H,hd]."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    logits = _scores(cfg, qg, k, mask, bf16=flags.ATTN_BF16_SOFTMAX)
    if flags.ATTN_BF16_SOFTMAX:
        # the logits / softmax chain stays bf16 (the row max subtracted,
        # outside the gradient)
        mx = torch.amax(logits, dim=-1, keepdim=True).detach()
        p = torch.exp(logits - mx)
        w = p / torch.sum(p, dim=-1, keepdim=True)
        out = _dot32("bkgqs,bskd->bqkgd", w, cast(v))
        return out.reshape(B, Sq, H, hd).to(COMPUTE_DTYPE)
    w = torch.softmax(logits, dim=-1)
    del logits
    out = _dot32("bkgqs,bskd->bqkgd", cast(w), cast(v))
    return out.reshape(B, Sq, H, hd).to(COMPUTE_DTYPE)


def _local_kv(q, k, v, ql, kl, vl):
    """Each local query head's KV head, where the shards do not keep the
    global grouping (query heads over the model axis, KV heads whole):
    the local K / V gathered to one head a query head."""
    H, KV, Hl, KVl = q.shape[2], k.shape[2], ql.shape[2], kl.shape[2]
    G = H // KV
    h0 = sharding.coordinate("model") * Hl if Hl != H else 0
    k0 = sharding.coordinate("model") * KVl if KVl != KV else 0
    idx = [(h0 + j) // G - k0 for j in range(Hl)]
    if Hl % KVl == 0 and idx == [j // (Hl // KVl) for j in range(Hl)]:
        return kl, vl
    return kl[:, :, idx], vl[:, :, idx]


def _attention(cfg: ModelConfig, q, k, v, mask):
    """:func:`attention_core`; under a mesh on each rank's shards: its
    batch rows and its query heads (over the model axis where they divide
    it), each with its own KV head (:func:`_local_kv`), and no collective
    (DTensor has no strategy for the grouped-head products)."""
    mesh = sharding._current_mesh()
    if mesh is None:
        return attention_core(cfg, q, k, v, mask)

    def local(ql, kl, vl, ml):
        kl, vl = _local_kv(q, k, v, ql, kl, vl)
        return attention_core(cfg, ql, kl, vl, ml)

    heads = ("batch", None, "model", None)
    qs = sharding.spec(mesh, *heads, shape=tuple(q.shape))
    ks = sharding.spec(mesh, *heads, shape=tuple(k.shape))
    rows = mask.ndim == 3 and mask.shape[0] == q.shape[0]
    ms = sharding.spec(mesh, "batch" if rows else None, None, None,
                       shape=tuple(mask.shape))
    # KV heads held whole by ranks that split the query heads: their
    # gradients are partial sums over the model axis
    gk = sharding.partial(qs[2] if ks[2] is None else None, ks)
    return sharding.on_shards(local, (q, k, v, mask), (qs, ks, ks, ms), qs,
                              (qs, gk, gk, ms))


def _project_qkv(cfg, p: Attention, x):
    q = project("bsd,dhk->bshk", cast(x), cast(p.wq), "wq")
    k = project("bsd,dhk->bshk", cast(x), cast(p.wk), "wk")
    v = project("bsd,dhk->bshk", cast(x), cast(p.wv), "wv")
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
    q = shard(q, "batch", None, "model", None)
    k = shard(k, "batch", None, "model", None)
    block = flags.BLOCKWISE_ATTN
    if block and q.shape[1] > block:
        out = attention_core_blockwise(
            cfg, q, k, v, positions, positions, causal=causal, window=window,
            prefix_len=prefix_len, block=block)
    else:
        mask = _attn_mask(positions, positions, causal=causal, window=window,
                          prefix_len=prefix_len, kv_valid=None)
        out = _attention(cfg, q, k, v, mask)
    out = project("bshk,hkd->bsd", cast(out), cast(p.wo), "wo")
    return shard(out, "batch", seq_axis(), None), (k, v)


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
    if sharding._current_mesh() is not None:
        out = _decode_on_shards(cfg, q, k_new, v_new, k_cache, v_cache, pos,
                                window)
    else:
        k_cache[:, pos:pos + 1] = k_new.to(k_cache.dtype)
        v_cache[:, pos:pos + 1] = v_new.to(v_cache.dtype)
        kv_pos = torch.arange(Smax, device=x.device)[None, :]
        mask = _attn_mask(posv, kv_pos, causal=True, window=window,
                          prefix_len=None, kv_valid=kv_pos <= pos)
        out = attention_core(cfg, q, k_cache, v_cache, mask)
    out = project("bshk,hkd->bsd", cast(out), cast(p.wo), "wo")
    return out, k_cache, v_cache


def _decode_on_shards(cfg: ModelConfig, q, k_new, v_new, k_cache, v_cache,
                      pos: int, window):
    """One decoded token's attention under a mesh, on each rank's shards of
    the cache as the KV-cache rule places it (``sharding.kv_cache_logical``;
    DTensor has no strategy for the grouped-head products nor for a
    write into a sharded sequence).  The rank holding position ``pos``
    writes the new key and value there; each rank attends over its cache
    slice.  Where the sequence is split, the slices' softmax is combined
    flash-decoding style: an all-reduce of the row max, then of the
    rescaled sums and weighted values over the sequence's mesh axes (the
    logits as :func:`attention_core` makes them, ``ATTN_BF16_SOFTMAX``
    included; the sums as :func:`attention_core_blockwise` keeps them)."""
    from torch.distributed import _functional_collectives as funcol

    mesh = sharding._current_mesh()
    shape = tuple(k_cache.shape)
    cs = sharding.spec(mesh, *sharding.kv_cache_logical(mesh, shape),
                       shape=shape)
    seq_axes = () if cs[1] is None else \
        (cs[1] if isinstance(cs[1], tuple) else (cs[1],))
    qs = (cs[0], None, cs[2], None)         # batch and heads as the cache
    dims = {a: mesh.axis_names.index(a) for a in seq_axes}
    hd = q.shape[-1]

    def local(ql, knl, vnl, kcl, vcl):
        Sl = kcl.shape[1]
        s0 = 0
        for a in seq_axes:
            s0 = s0 * sharding._axis_prod(mesh, a) + sharding.coordinate(a)
        s0 *= Sl
        if s0 <= pos < s0 + Sl:
            kcl[:, pos - s0:pos - s0 + 1] = knl.to(kcl.dtype)
            vcl[:, pos - s0:pos - s0 + 1] = vnl.to(vcl.dtype)
        kl, vl = _local_kv(q, k_cache, v_cache, ql, kcl, vcl)
        kv_pos = s0 + torch.arange(Sl, device=ql.device)[None, :]
        posv = torch.full((ql.shape[0], 1), pos, dtype=torch.int32,
                          device=ql.device)
        mask = _attn_mask(posv, kv_pos, causal=True, window=window,
                          prefix_len=None, kv_valid=kv_pos <= pos)
        if not seq_axes:
            return attention_core(cfg, ql, kl, vl, mask)
        B, Sq, H, _ = ql.shape
        qg = ql.reshape(B, Sq, kl.shape[2], H // kl.shape[2], hd)
        logits = _scores(cfg, qg, kl, mask, bf16=flags.ATTN_BF16_SOFTMAX)
        m = torch.amax(logits, dim=-1).float()
        for a in seq_axes:
            m = funcol.all_reduce(m, "max", (mesh.mesh, dims[a]))
        l, acc = _exp_sums(logits, m.to(logits.dtype), vl)
        for a in seq_axes:
            l = funcol.all_reduce(l, "sum", (mesh.mesh, dims[a]))
            acc = funcol.all_reduce(acc, "sum", (mesh.mesh, dims[a]))
        return _normalized(acc, l)

    return sharding.on_shards(local, (q, k_new, v_new, k_cache, v_cache),
                              (qs, qs, qs, cs, cs), qs)


def cross_attention(cfg: ModelConfig, p: Attention, x, k_enc, v_enc):
    """Decoder cross-attention to precomputed encoder K/V (no positions)."""
    q = project("bsd,dhk->bshk", cast(x), cast(p.wq), "wq")
    Skv = k_enc.shape[1]
    mask = torch.ones((1, x.shape[1], Skv), dtype=torch.bool, device=x.device)
    out = _attention(cfg, q, k_enc, v_enc, mask)
    return project("bshk,hkd->bsd", cast(out), cast(p.wo), "wo")


def encode_kv(cfg: ModelConfig, p: Attention, enc_out):
    k = project("bsd,dhk->bshk", cast(enc_out), cast(p.wk), "wk")
    v = project("bsd,dhk->bshk", cast(enc_out), cast(p.wv), "wv")
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
    up = project("bsd,df->bsf", cast(x), cast(p.w_up), "w_up")
    if cfg.mlp == "swiglu":
        gate = project("bsd,df->bsf", cast(x), cast(p.w_gate), "w_gate")
        h = F.silu(gate) * up
    elif cfg.mlp == "geglu":
        gate = project("bsd,df->bsf", cast(x), cast(p.w_gate), "w_gate")
        h = F.gelu(gate, approximate="tanh") * up
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(up))
    else:
        raise ValueError(cfg.mlp)
    h = shard(h, "batch", None, "model")
    out = project("bsf,fd->bsd", h, cast(p.w_down), "w_down")
    return shard(out, "batch", seq_axis(), None)
