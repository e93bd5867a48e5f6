"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B] — 128 experts top-8, qk-norm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", moe=True,
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    num_experts=128, top_k=8, num_shared_experts=0, moe_d_ff=1536,
    rope_theta=1_000_000.0, qk_norm=True,
    mlp="swiglu", tie_embeddings=False,
)
