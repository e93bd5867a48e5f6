"""Architecture configuration shared by the whole model zoo.

A copy of the reference's ``repro.models.config`` (pure Python): the port
keeps its own so that it imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    rope_theta: float = 10_000.0
    window: int | None = None        # sliding-window size for 'local' layers
    layer_pattern: str = "full"      # full | local_global | mostly_local
    n_global_layers: int = 0         # for mostly_local (hymba)
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qk_norm: bool = False            # qwen3
    scale_embedding: bool = False    # gemma family: embed * sqrt(D)
    sandwich_norm: bool = False      # gemma2 post-norms

    # --- mlp ---
    mlp: str = "swiglu"              # swiglu | geglu | relu2

    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.0

    # --- SSM (mamba2 / hymba SSM path) ---
    ssm: bool = False
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (hymba: parallel attn + ssm heads) ---
    hybrid: bool = False

    # --- encoder-decoder (seamless) ---
    encoder_layers: int = 0
    cross_attention: bool = False

    # --- modality frontend stubs (paligemma / seamless) ---
    frontend: str | None = None      # vision | audio
    frontend_dim: int = 0            # raw embedding dim fed by the stub
    frontend_len: int = 256          # prefix length (patches / frames)

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    sub_quadratic: bool = False      # eligible for long_500k

    # reduced smoke-test proportions
    def reduced(self) -> "ModelConfig":
        d_model = 64
        head_dim = 16
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(heads, self.num_kv_heads * heads // max(self.num_heads, 1)))
        return dataclasses.replace(
            self,
            num_layers=2,
            encoder_layers=2 if self.encoder_layers else 0,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=128,
            moe_d_ff=32 if self.moe else 0,
            num_experts=8 if self.moe else 0,
            top_k=min(2, self.top_k) if self.moe else 0,
            vocab_size=512,
            window=8 if self.window else None,
            ssm_state=8 if (self.ssm or self.hybrid) else 0,
            ssm_head_dim=16 if (self.ssm or self.hybrid) else 0,
            ssm_chunk=16,
            frontend_dim=32 if self.frontend else 0,
            frontend_len=4 if self.frontend else 0,
            n_global_layers=min(1, self.n_global_layers),
        )

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return max(self.d_inner // max(self.ssm_head_dim, 1), 1)

    def param_count(self) -> int:
        """Total parameters N (analytic; used for 6ND roofline checks)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
        total = V * D                                   # embedding
        if not self.tie_embeddings:
            total += V * D
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D

        def mlp_params(ff):
            gates = 2 if self.mlp in ("swiglu", "geglu") else 1
            return gates * D * ff + ff * D

        if self.family == "ssm":
            di, N_, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            g = 1                                        # n_groups
            zxbcdt = D * (2 * di + 2 * g * N_ + Hs)
            ssm = zxbcdt + di * D + self.ssm_conv * (di + 2 * g * N_) + 3 * Hs
            total += L * (ssm + D)                       # + norm
            total += D
            return total

        per_layer = attn + 2 * D                         # norms
        if self.sandwich_norm:
            per_layer += 2 * D
        if self.moe:
            E, Fe = self.num_experts, self.moe_d_ff
            per_layer += D * E + E * mlp_params(Fe)
            if self.num_shared_experts:
                per_layer += mlp_params(Fe * self.num_shared_experts)
        else:
            per_layer += mlp_params(F)
        if self.hybrid:
            di, N_, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer += D * (2 * di + 2 * N_ + Hs) + di * D \
                + self.ssm_conv * (di + 2 * N_) + 3 * Hs
        if self.cross_attention:
            per_layer += attn                            # decoder cross-attn
        total += L * per_layer
        total += self.encoder_layers * (attn + mlp_params(F) + 2 * D)
        if self.frontend:
            total += self.frontend_dim * D               # stub projection
        total += D                                       # final norm
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top_k + shared)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        E, Fe, D = self.num_experts, self.moe_d_ff, self.d_model
        gates = 2 if self.mlp in ("swiglu", "geglu") else 1
        per_exp = gates * D * Fe + Fe * D
        inactive = self.num_layers * (E - self.top_k) * per_exp
        return full - inactive
