"""hymba-1.5b [arXiv:2411.13676] — parallel attention + mamba heads.

Simplifications noted in DESIGN.md: mean fusion of the two paths, no meta
tokens / cross-layer KV sharing.  3 global-attention layers (first, middle,
last), the rest sliding-window — hence sub-quadratic / long_500k eligible.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", hybrid=True,
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    mlp="swiglu", layer_pattern="mostly_local", window=1024,
    n_global_layers=3,
    ssm=True, ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    tie_embeddings=True, sub_quadratic=True,
)
