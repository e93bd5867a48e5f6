"""Big-means x the LM zoo: build a vector-quantization codebook over the
activations of any ``--arch`` model (reduced config by default), the
reference's ``examples/embedding_clustering.py``.

    PYTHONPATH=src python -m repro_torch.examples.embedding_clustering \
        --arch hymba-1.5b [--device cpu]

The paper's technique works on data, so it composes with every assigned
architecture without changing its forward pass: the model's activations
are harvested, then ``fit`` and ``evaluate`` cluster them (kernels A, B
and C on the card).  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import device as devices
from repro_torch.api import evaluate, fit
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config, model_fns

HARVEST_WIDTH = 128


def harvest(cfg, model, tokens, frames=None) -> torch.Tensor:
    """The activation rows ``[B·S, ≤128]`` f32 of one forward: the first
    128 logit columns of every position (any activation works)."""
    mod = model_fns(cfg)
    if cfg.family == "encdec":
        logits, _ = mod.forward(cfg, model, tokens, frames)
    elif cfg.family == "vlm":
        logits, _ = mod.forward(cfg, model, tokens, frontend=frames)
    else:
        logits, _ = mod.forward(cfg, model, tokens)
    H = logits.reshape(-1, logits.shape[-1]).float()
    return H[:, :HARVEST_WIDTH].clone()


def main(argv=None) -> dict:
    """Harvest a reduced model's activations, fit a codebook, evaluate it,
    print the reference's two lines; returns what was printed, as numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--codebook", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)

    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = T.init_params(cfg, gen, device=dev)

    # harvest activations from a batch of synthetic sequences
    B, S = 16, 64
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((B, 16, cfg.frontend_dim), generator=gen,
                             device=dev)
    elif cfg.family == "vlm":
        frames = torch.randn((B, cfg.frontend_len, cfg.frontend_dim),
                             generator=gen, device=dev)
    H = harvest(cfg, model, tokens, frames)
    print(f"{args.arch}: clustering {H.shape[0]} activation vectors "
          f"({H.shape[1]}-d) into a {args.codebook}-entry codebook")

    result = fit(H, k=args.codebook, s=min(512, H.shape[0]), n_chunks=25,
                 seed=args.seed, device=dev)
    _, f = evaluate(result, H, device=dev)
    mse = f / H.numel()
    var = float(torch.var(H, correction=0))
    print(f"codebook quantization MSE/dim = {mse:.5f} "
          f"(activation variance {var:.5f}, "
          f"compression residual {mse / var:.1%})")
    return {"rows": H.shape[0], "width": H.shape[1], "mse": mse,
            "variance": var, "objective": f, "result": result}


if __name__ == "__main__":
    main()
