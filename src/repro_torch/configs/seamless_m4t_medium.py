"""seamless-m4t-medium [arXiv:2308.11596] — enc-dec, audio frontend stub.

12 encoder + 12 decoder layers (the released medium topology); input_specs
feeds precomputed audio frame embeddings [B, S_src, 1024].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    mlp="swiglu", tie_embeddings=False,
    encoder_layers=12, cross_attention=True,
    frontend="audio", frontend_dim=1024, frontend_len=4096,
)
