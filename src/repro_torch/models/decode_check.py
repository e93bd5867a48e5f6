"""A decode held to the forward over the same tokens.

:func:`decode_gap` prefills all but the last ``n_decode`` tokens of a
sequence into a cache of the sequence's length, decodes those tokens one
at a time, and compares the decode with one forward over the whole
sequence (which also collects the cache the decode should end with):

* each step's logits against the forward's at that position;
* the decode cache after the last step against the forward's: the K / V
  rows the decode wrote and the prefill's last row before them, the SSD
  state and conv window after the last token.

:func:`decode_faults` holds both to their bounds.  The reference's test
(``tests/test_decode_consistency.py:19-23``) holds the logits to 1e-3
(hymba 0.15) on the CPU at 2 layers of 64 wide, where a product's row does
not depend on how many rows the product has.  On an H100 cuBLAS picks other
kernels at M = 2 than at M = 512, so bf16 products round otherwise, a
router's top-k can flip where two experts nearly tie, and hymba's SSD adds
the gap between its chunked form (bf16 casts) and its recurrent one at
every layer: its logits 0.18-0.21 off at 8 layers, 0.40-0.43 at 16 and
0.59-0.75 at 32, its decode cache 0.08, 0.11 and 0.22 of its norm
(``tools/zoo_decode_gap.py``, seeds 0-2).  With random weights attention is spread over the whole
1,024-token window, so a K / V row written one slot early moves hymba's
logits by no more than that gap (0.13 of their norm against 0.12-0.15),
but its cache by 1.37; the cache comparison is what sees it
(``tools/zoo_decode_faults.py``, full width, seeds 0 and 1).  A window
one token wider moves neither beyond the gap, and is not seen.

:func:`planted` is the harness that shows the check sees a wrong decode:
it replaces one function of the decode path with a faulty one (``FAULTS``)
for the length of a ``with``; ``tools/zoo_decode_faults.py`` runs it at
full width on the card.
"""
from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe, registry, ssm
from repro_torch.models import transformer as T

BF16_STEP = 2.0 ** -7
DECODE_STEPS = 4.0       # bf16 steps of a step's logit scale, for the rows
#                          that every layer routed as the forward did
#                          (up to 1.7 on the card over seeds 0-4)
DECODE_REL = 0.5         # |decoded - forward| / |forward| over a step's
#                          logits (2-norm); unrelated logits give ~1.4
HYMBA_DECODE_TOL = 1.2   # 1.6x the largest of 0.59-0.75 at 32 layers; no
#                          window at all gives 1.63-1.85
ROUTE_TIE = 1e-3         # a route differs only where the forward's K-th and
#                          (K+1)-th router probabilities were this close
#                          (the largest of 19 reroutes over 4 seeds: 2.4e-4)
CACHE_REL = 0.05         # |decode cache - forward's| / |forward's| per layer
#                          and entry, over the rows compared (measured up to
#                          0.011; a slot written early gives 1.37)
HYMBA_CACHE_REL = 0.3    # the SSD's drift: up to 0.22 at 32 layers; no
#                          window 0.40, SSD state not carried 0.95 and up


def random_inputs(cfg, batch: int, seq: int, gen, device, *,
                  frames: int = 1024):
    """Random tokens [batch, seq] and, for the encoder-decoder, random
    frames [batch, frames, frontend_dim], drawn from ``gen``."""
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=device)
    feats = None
    if cfg.family == "encdec":
        feats = torch.randn((batch, frames, cfg.frontend_dim), generator=gen,
                            device=device)
    return tokens, feats


def forward(cfg, model, tokens, frames, *, collect_cache: bool = False):
    """The arch's forward: (logits [B, S, V], caches or None)."""
    mod = registry.model_fns(cfg)
    if cfg.family == "encdec":
        return mod.forward(cfg, model, tokens, frames,
                           collect_cache=collect_cache)
    return mod.forward(cfg, model, tokens, collect_cache=collect_cache)


def _timed(fn, device):
    """(fn(), its wall in ms), a card synchronized on both sides."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.monotonic()
    out = fn()
    sync()
    return out, 1e3 * (time.monotonic() - t0)


class RouteLog:
    """Within its ``with``, records each ``moe.route`` call: the experts
    chosen for every token (as sets) and the margin between the K-th and
    (K+1)-th router probability."""

    def __enter__(self):
        self.calls, self.real = [], moe.route

        def route(cfg, p, xt):
            top_p, top_e = self.real(cfg, p, xt)
            probs = torch.softmax(xt.float() @ p.router.float(), dim=-1)
            two = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            self.calls.append((torch.sort(top_e, dim=-1).values,
                               two[:, -2] - two[:, -1]))
            return top_p, top_e

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self.real


def _rel(a, b) -> float:
    """The largest per-layer |a - b| / |b| (2-norms over all but dim 0)."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    num = torch.linalg.vector_norm(a - b, dim=1)
    den = torch.linalg.vector_norm(b, dim=1).clamp_min(1e-30)
    return float((num / den).max())


def _cache_rel(cache: dict, ref: dict, rows, S0: int, S: int) -> dict:
    """Per entry, the largest per-layer relative gap over ``rows`` (the
    batch rows compared): K / V over positions S0 - 1 .. S - 1, the SSD
    state and conv window whole."""
    out = {}
    for key in ("k", "v"):
        if key in cache:
            out[key] = _rel(cache[key][:, rows, S0 - 1:S],
                            ref[key][:, rows, S0 - 1:S])
    if "ssm" in cache:
        for key in ("state", "conv"):
            out[f"ssm_{key}"] = _rel(cache["ssm"][key][:, rows],
                                     ref["ssm"][key][:, rows])
    return out


def decode_gap(cfg, model, tokens, frames, n_decode: int) -> dict:
    """Prefill ``tokens[:, :S - n_decode]``, decode the rest one at a time,
    and compare with the forward over all S tokens.

    Per step: the largest |decoded - forward| logit over all rows and over
    the rows that every layer routed as the forward did (``held``), the
    forward's logit scale there, the share of rows with the forward's
    argmax, the 2-norm gap relative to the forward's, and under MoE the
    rerouted rows and, over them, the forward's router margin at the first
    layer that routed them otherwise.  Then the cache gap
    (``cache_rel``) over the rows that no step rerouted."""
    mod = registry.model_fns(cfg)
    dev = tokens.device
    B, S = tokens.shape
    S0 = S - n_decode
    with RouteLog() as fwd_routes:
        full, ref_cache = forward(cfg, model, tokens, frames,
                                  collect_cache=True)
    if cfg.family == "encdec":
        (_, cache), pre_ms = _timed(lambda: mod.prefill(
            cfg, model, tokens[:, :S0], frames, S), dev)
    else:
        (_, cache), pre_ms = _timed(lambda: mod.prefill(
            cfg, model, tokens[:, :S0], S), dev)
    steps = []
    ever = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(S0, S):
        with RouteLog() as routes:
            (lg, cache), ms = _timed(lambda: mod.decode_step(
                cfg, model, cache, tokens[:, t:t + 1], t), dev)
        want = full[:, t]
        err = (lg - want).abs().amax(-1)                     # [B]
        # a row's first rerouted layer must be a near tie; its later
        # layers see another input and may route otherwise
        rows = torch.arange(B, device=dev) * S + t
        rerouted = torch.zeros(B, dtype=torch.bool, device=dev)
        margin_max = None
        for (e_fwd, margin), (e_dec, _) in zip(fwd_routes.calls,
                                               routes.calls):
            first = (e_fwd[rows] != e_dec).any(-1) & ~rerouted
            if bool(first.any()):
                m = float(margin[rows][first].max())
                margin_max = max(margin_max or 0.0, m)
            rerouted |= first
        ever |= rerouted
        held = ~rerouted
        steps.append({
            "t": t, "ms": ms, "max_abs_err": float(err.max()),
            "held_max_abs_err": (float(err[held].max()) if bool(held.any())
                                 else None),
            "rows_rerouted": int(rerouted.sum()),
            "scale": float(want.abs().max()),
            "top1": float((lg.argmax(-1) == want.argmax(-1)).float().mean()),
            "rel": float(torch.linalg.vector_norm(lg - want)
                         / torch.linalg.vector_norm(want)),
            "tie_margin": margin_max})
    kept = (~ever).nonzero().flatten()
    return {"prefill_tokens": S0, "prefill_ms": pre_ms, "steps": steps,
            "max_abs_err": max(s["max_abs_err"] for s in steps),
            "top1": sum(s["top1"] for s in steps) / len(steps),
            "rel": max(s["rel"] for s in steps),
            "steps_rerouted": sum(s["rows_rerouted"] > 0 for s in steps),
            "cache_rows": int(kept.numel()),
            "cache_rel": (_cache_rel(cache, ref_cache, kept, S0, S)
                          if kept.numel() else {})}


def decode_faults(dec: dict, hybrid: bool) -> list[str]:
    """What of :func:`decode_gap`'s result breaks its bounds (empty when
    the decode holds): every step within ``DECODE_REL`` of the forward's
    norm; hymba's largest gap under ``HYMBA_DECODE_TOL``; elsewhere the
    held rows within ``DECODE_STEPS`` bf16 steps of the step's scale and a
    rerouted row only at a router margin up to ``ROUTE_TIE``; every cache
    entry within ``CACHE_REL`` (hymba ``HYMBA_CACHE_REL``)."""
    out = []
    if dec["rel"] > DECODE_REL:
        out.append(f"decoded logits {dec['rel']:.3f} of the forward's norm "
                   "away from it")
    if hybrid and dec["max_abs_err"] > HYMBA_DECODE_TOL:
        out.append(f"decode off the forward by {dec['max_abs_err']}")
    for s in dec["steps"] if not hybrid else ():
        bound = DECODE_STEPS * BF16_STEP * s["scale"]
        if s["held_max_abs_err"] is not None and \
                s["held_max_abs_err"] > bound:
            out.append(f"step {s['t']} off the forward by "
                       f"{s['held_max_abs_err']} (scale {s['scale']})")
        if s["tie_margin"] is not None and s["tie_margin"] > ROUTE_TIE:
            out.append(f"step {s['t']} rerouted a row whose router margin "
                       f"was {s['tie_margin']}")
    bound = HYMBA_CACHE_REL if hybrid else CACHE_REL
    for key, rel in dec["cache_rel"].items():
        if rel > bound:
            out.append(f"decode cache {key} {rel:.3e} of the forward's "
                       "away from it")
    return out


# ---------------------------------------------------------------------------
# Planted faults
# ---------------------------------------------------------------------------
FAULTS = {
    "ssd_state_zeroed": "the prefill's SSD state never reaches the decode "
                        "cache (zeros in its place)",
    "ssd_state_stale": "each decode step leaves the SSD state as it was",
    "kv_write_pos_minus_1": "each decode step writes its key and value one "
                            "slot early (RoPE and mask at the right place)",
    "window_none": "the windowed layers decode with no window",
    "window_plus_1": "the windowed layers decode with a window one token "
                     "wider",
}


def _attention_decode_early(cfg, p, x, k_cache, v_cache, pos, *,
                            window=None):
    """``layers.self_attention_decode`` with the cache slot one early."""
    B, Smax = k_cache.shape[0], k_cache.shape[1]
    pos = int(pos)
    q, k_new, v_new = L._project_qkv(cfg, p, x)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = L.rope(q, posv, cfg.rope_theta)
    k_new = L.rope(k_new, posv, cfg.rope_theta)
    k_cache[:, pos - 1:pos] = k_new.to(k_cache.dtype)
    v_cache[:, pos - 1:pos] = v_new.to(v_cache.dtype)
    kv_pos = torch.arange(Smax, device=x.device)[None, :]
    mask = L._attn_mask(posv, kv_pos, causal=True, window=window,
                        prefix_len=None, kv_valid=kv_pos <= pos)
    out = L.attention_core(cfg, q, k_cache, v_cache, mask)
    return (torch.einsum("bshk,hkd->bsd", L.cast(out), L.cast(p.wo)),
            k_cache, v_cache)


@contextlib.contextmanager
def planted(fault: str | None):
    """Within the ``with``, the decode path carries ``fault`` (a key of
    ``FAULTS``; None plants nothing)."""
    if fault is None:
        yield
        return
    if fault == "ssd_state_zeroed":
        mod, name, real = T, "_fill", T._fill

        def new(cache, caches):
            real(cache, caches)
            cache["ssm"]["state"].zero_()
    elif fault == "ssd_state_stale":
        mod, name, real = ssm, "ssd_decode", ssm.ssd_decode

        def new(cfg, p, x, cache):
            out, upd = real(cfg, p, x, cache)
            return out, {"conv": upd["conv"], "state": cache["state"]}
    elif fault == "kv_write_pos_minus_1":
        mod, name, real = L, "self_attention_decode", L.self_attention_decode
        new = _attention_decode_early
    elif fault in ("window_none", "window_plus_1"):
        mod, name, real = T, "block_decode", T.block_decode

        def new(cfg, lp, x, cache, pos, window):
            if window != T.FULL_WINDOW:
                window = (T.FULL_WINDOW if fault == "window_none"
                          else window + 1)
            return real(cfg, lp, x, cache, pos, window)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(mod, name, new)
    try:
        yield
    finally:
        setattr(mod, name, real)
