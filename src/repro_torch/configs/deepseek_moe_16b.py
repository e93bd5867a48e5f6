"""deepseek-moe-16b [arXiv:2401.06066] — fine-grained MoE, 2 shared + 64 routed top-6.

Simplification noted in DESIGN.md: all 28 layers are MoE (the release keeps
layer 0 dense); the 2 shared experts supply the dense path in every layer.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", moe=True,
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    num_experts=64, top_k=6, num_shared_experts=2, moe_d_ff=1408,
    mlp="swiglu", tie_embeddings=False,
)
