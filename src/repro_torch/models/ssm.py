"""Mamba2 (state-space duality) sequence mixer, the reference's
``repro.models.ssm``.

The chunked SSD algorithm of the Mamba2 paper (arXiv:2405.21060): the
sequence is split into chunks of Q tokens; within a chunk the recurrence is
a masked, decay-weighted attention-like contraction, and across chunks a
[B,H,P,N] state runs through the chunks in order (the reference's
``lax.scan``, a loop here).  Decode is the O(1) state update.  The
reference's hard-coded bf16 casts stay where it has them.  n_groups = 1
(B/C shared across heads).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import flags
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Norm, _dot32, cast, const, param, rmsnorm
from repro_torch.train import sharding
from repro_torch.train.sharding import shard


def _dims(cfg: ModelConfig):
    return cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim


class SSM(nn.Module):
    """in_proj [D, 2di+2N+H], conv_w [w, di+2N], conv_b, A_log, ssm_D,
    dt_bias [H], gate_norm [di], out_proj [di, D]."""

    def __init__(self, cfg: ModelConfig, gen, *, device, dtype):
        super().__init__()
        di, N, H, _ = _dims(cfg)
        D = cfg.d_model
        conv_ch = di + 2 * N
        kw = dict(device=device, dtype=dtype)
        self.in_proj = param(gen, (D, 2 * di + 2 * N + H), D ** -0.5, **kw)
        self.conv_w = param(gen, (cfg.ssm_conv, conv_ch),
                            cfg.ssm_conv ** -0.5, **kw)
        self.conv_b = const((conv_ch,), 0.0, **kw)
        self.A_log = const((H,), 0.0, **kw)                  # A = -exp(A_log)
        self.ssm_D = const((H,), 1.0, **kw)
        self.dt_bias = const((H,), 0.0, **kw)
        self.gate_norm = Norm(di, **kw)
        self.out_proj = param(gen, (di, D), di ** -0.5, **kw)


def init_ssm(cfg: ModelConfig, gen, *, device, dtype) -> SSM:
    return SSM(cfg, gen, device=device, dtype=dtype)


def _split_proj(cfg, p: SSM, x):
    di, N, H, _ = _dims(cfg)
    zxbcdt = sharding.project("bsd,dz->bsz", cast(x), cast(p.in_proj),
                              "in_proj")
    return torch.split(zxbcdt, [di, di, N, N, H], dim=-1)


def _causal_conv_full(w: dict, u):
    """Depthwise causal conv over [B,S,C] with width w."""
    cw = w["conv_w"]                                         # [w, C]
    width, S = cw.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + up[:, i:i + S, :] * cast(cw[i])[None, None, :]
    return out + cast(w["conv_b"])[None, None, :]


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_full(cfg: ModelConfig, p: SSM, x):
    """Full-sequence Mamba2 mixer.

    x [B,S,D] -> (y [B,S,D], cache {'conv': [B,w-1,C], 'state': [B,H,P,N]})
    where the cache is the decode-ready state after the last token.
    Between the two projections the mixer runs on each rank's batch rows
    under a mesh (:func:`_on_rows`).
    """
    parts = _split_proj(cfg, p, x)
    y, conv_tail, h = _on_rows(_ssd_core, cfg, p, parts, 3)
    out = sharding.project("bsd,dk->bsk", cast(y), cast(p.out_proj),
                           "out_proj")
    return shard(out, "batch", None, None), {"conv": conv_tail, "state": h}


def _core_params(p: SSM) -> dict:
    """The mixer's parameters between its two projections."""
    return {"conv_w": p.conv_w, "conv_b": p.conv_b, "A_log": p.A_log,
            "ssm_D": p.ssm_D, "dt_bias": p.dt_bias,
            "norm": p.gate_norm.scale}


def _on_rows(core, cfg: ModelConfig, p: SSM, acts: tuple, n_out: int):
    """``core(cfg, params, *acts)``; under a mesh on each rank's batch rows
    (``sharding.on_shards``): the activations and the ``n_out`` results
    split by batch, the parameters whole.  DTensor has no strategy for the
    chunked scan's grouped products; every op of the core is row-local, so
    the shards need no collective."""
    w = _core_params(p)
    mesh = sharding._current_mesh()
    if mesh is None:
        return core(cfg, w, *acts)
    names = list(w)

    def local(*tensors):
        return core(cfg, dict(zip(names, tensors)), *tensors[len(names):])

    rows = [sharding.spec(mesh, "batch", *(None,) * (a.ndim - 1),
                          shape=tuple(a.shape)) for a in acts]
    whole = [(None,) * t.ndim for t in w.values()]
    # each rank's rows add their part to the parameters' gradients
    grads = [sharding.partial(rows[0][0], s) for s in whole]
    return sharding.on_shards(local, (*w.values(), *acts), (*whole, *rows),
                              [rows[0]] * n_out, (*grads, *rows))


def _ssd_core(cfg: ModelConfig, w: dict, z, xs, Bc, Cc, dt):
    di, N, H, P = _dims(cfg)
    B_, S, _ = z.shape
    Q = min(cfg.ssm_chunk, S)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    tail = max(cfg.ssm_conv - 1, 0)
    conv_tail = conv_in[:, S - tail:, :] if tail else conv_in[:, :0, :]
    conv_out = F.silu(_causal_conv_full(w, conv_in))
    xs, Bc, Cc = torch.split(conv_out, [di, N, N], dim=-1)

    dt = _softplus(dt.float() + w["dt_bias"].float())

    # Pad the sequence to a chunk multiple; padded steps get dt=0 (identity
    # state transition, zero input) so the returned state is exact.
    S_pad = -(-S // Q) * Q
    if S_pad != S:
        pad = (0, 0, 0, S_pad - S)
        xs, Bc, Cc, dt = (F.pad(t, pad) for t in (xs, Bc, Cc, dt))
    nc = S_pad // Q
    A = -torch.exp(w["A_log"].float())                          # [H]

    xh = xs.reshape(B_, nc, Q, H, P)
    dtc = dt.reshape(B_, nc, Q, H)
    Bch = Bc.reshape(B_, nc, Q, N).float()
    Cch = Cc.reshape(B_, nc, Q, N).float()

    dA = dtc * A[None, None, None, :]                        # [B,c,Q,H] (<=0)
    cum = torch.cumsum(dA, dim=2)                            # within-chunk

    # ---- intra-chunk (attention-like, masked decay) ----
    # the [B,c,Q,Q,H] tensors in f32, or in bf16 under flags.SSD_BF16
    # The decay is masked before its exp as well as after: above the
    # diagonal cum[q] - cum[t] >= 0 grows with the chunk (past exp's f32
    # range at Q = 256 with dt ~ 0.7), and exp's backward multiplies the
    # masked zero gradient by that inf.  The values are the reference's
    # (exp(-inf) = 0 is the zero it selects); its gradient is NaN there.
    sdt = torch.bfloat16 if flags.SSD_BF16 else torch.float32
    CB = _dot32("bcqn,bctn->bcqt", Cch, Bch).to(sdt)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=z.device))
    tri = tri[None, None, :, :, None]
    diff = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(sdt)
    decay = torch.exp(torch.where(tri, diff, -torch.inf))
    del diff
    w_ = torch.where(tri, decay, torch.zeros((), dtype=sdt, device=z.device))
    del decay
    scores = CB[..., None] * w_ * dtc[:, :, None, :, :].to(sdt)
    del w_
    y_intra = _dot32("bcqth,bcthp->bcqhp", scores.to(torch.bfloat16), cast(xh))
    del scores

    # ---- chunk states + inter-chunk recurrence ----
    last = cum[:, :, -1:, :]                                 # [B,c,1,H]
    wS = torch.exp(last - cum) * dtc                         # [B,c,Q,H]
    S_c = _dot32("bcth,bctn,bcthp->bchpn", wS.to(torch.bfloat16),
                 Bch.to(torch.bfloat16), cast(xh))           # [B,c,H,P,N]
    chunk_decay = torch.exp(last[:, :, 0, :])                # [B,c,H]

    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=z.device)
    h_prev = []                                              # state entering chunk
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)                      # [B,c,H,P,N]

    y_inter = _dot32("bcqn,bcqh,bchpn->bcqhp", Cch.to(torch.bfloat16),
                     torch.exp(cum).to(torch.bfloat16),
                     h_prev.to(torch.bfloat16))

    y = (y_intra + y_inter + w["ssm_D"].float()[None, None, None, :, None]
         * xh.float())
    y = y.reshape(B_, S_pad, di)[:, :S, :]
    y = rmsnorm(y * F.silu(z.float()), w["norm"], cfg.norm_eps)
    return y, conv_tail, h


def init_ssm_cache(cfg: ModelConfig, batch: int, *, device,
                   dtype=torch.float32):
    di, N, H, P = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
    }


def ssd_decode(cfg: ModelConfig, p: SSM, x, cache):
    """One-token state update.  x [B,1,D] -> (y [B,1,D], new cache); the
    update runs on each rank's batch rows under a mesh (:func:`_on_rows`)."""
    parts = _split_proj(cfg, p, x)
    y, new_conv, state = _on_rows(_decode_core, cfg, p,
                                  (*parts, cache["conv"], cache["state"]), 3)
    out = sharding.project("bsd,dk->bsk", cast(y), cast(p.out_proj),
                           "out_proj")
    return out, {"conv": new_conv, "state": state}


def _decode_core(cfg: ModelConfig, w: dict, z, xs, Bc, Cc, dt, conv, state):
    di, N, H, P = _dims(cfg)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)                # [B,1,C]
    hist = torch.cat([conv, conv_in], dim=1)                 # [B,w,C]
    cw = cast(w["conv_w"])                                   # [w,C]
    conv_out = torch.einsum("bwc,wc->bc", cast(hist), cw) + cast(w["conv_b"])
    conv_out = F.silu(conv_out)[:, None, :]
    new_conv = hist[:, 1:, :]
    xs, Bc, Cc = torch.split(conv_out, [di, N, N], dim=-1)

    dt = _softplus(dt.float() + w["dt_bias"].float())
    A = -torch.exp(w["A_log"].float())
    dA = torch.exp(dt[:, 0, :] * A[None, :])                 # [B,H]

    xh = xs.reshape(-1, H, P).float()
    Bv = Bc[:, 0, :].float()                                 # [B,N]
    Cv = Cc[:, 0, :].float()
    dtv = dt[:, 0, :]                                        # [B,H]

    state = state * dA[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtv, xh, Bv)
    y = torch.einsum("bhpn,bn->bhp", state, Cv)
    y = y + w["ssm_D"].float()[None, :, None] * xh
    y = y.reshape(-1, 1, di)
    y = rmsnorm(y * F.silu(z.float()), w["norm"], cfg.norm_eps)
    return y, new_conv, state
