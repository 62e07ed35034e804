"""Unified model configuration for the 10 assigned architectures (a copy
of ``repro.models.config``, which the port may not import)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0    # decoupled RoPE dims per head
    v_head_dim: int = 0

    # --- SSM (mamba2 / zamba2) ---
    ssm: bool = False
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    hybrid_attn_every: int = 0   # zamba2: shared attn block every k layers

    # --- encoder-decoder (whisper) ---
    enc_dec: bool = False
    enc_layers: int = 0
    enc_frames: int = 1500       # stubbed conv-frontend output length

    # --- VLM (internvl) ---
    vlm_patches: int = 0         # stubbed ViT-frontend patch count

    # --- misc ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- sharding hints ---
    attn_head_tp: bool = True    # heads divisible by TP → head-sharded attn
    fsdp: bool = False           # shard params/opt-state over "data" too

    @property
    def d_inner(self) -> int:           # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def qk_head_dim(self) -> int:
        if self.use_mla:
            return self.head_dim + self.rope_head_dim
        return self.head_dim

    def param_count(self) -> int:
        """Approximate parameter count (for MODEL_FLOPS and reporting)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.ssm:
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            # in_proj (z,x,B,C,dt) + out_proj + conv + A,D
            per_layer += d * (2 * di + 2 * ds + nh) + di * d
            per_layer += (di + 2 * ds) * self.conv_width + 2 * nh
        if not self.ssm or self.hybrid_attn_every:
            if self.use_mla:
                attn = (d * self.q_lora_rank
                        + self.q_lora_rank * self.num_heads * self.qk_head_dim
                        + d * (self.kv_lora_rank + self.rope_head_dim)
                        + self.kv_lora_rank * self.num_heads
                        * (self.head_dim + self.v_head_dim)
                        + self.num_heads * self.v_head_dim * d)
            else:
                attn = d * self.num_heads * self.head_dim * 2 \
                    + d * self.num_kv_heads * self.head_dim * 2
            if self.hybrid_attn_every:
                n_attn = -(-self.num_layers // self.hybrid_attn_every)
                # shared params applied at n_attn points — counted ONCE
                per_layer = per_layer  # mamba layers counted above
                extra = attn + 3 * d * ff if ff else attn
                return emb + self.num_layers * per_layer + extra
            per_layer += attn
        if self.moe:
            per_layer += d * self.num_experts * ff * 3 \
                + d * self.num_shared_experts * ff * 3 \
                + d * self.num_experts
        elif ff:
            per_layer += 3 * d * ff
        n = self.num_layers * per_layer + emb
        if self.enc_dec:
            # encoder layers (self-attn + mlp) + decoder cross-attn
            enc = self.enc_layers * (4 * d * self.num_heads * self.head_dim
                                     + 2 * d * ff)
            cross = self.num_layers * 4 * d * self.num_heads * self.head_dim
            n += enc + cross
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k + shared; = param_count for
        dense)."""
        if not self.moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        total = self.param_count()
        routed_all = self.num_layers * d * self.num_experts * ff * 3
        routed_active = self.num_layers * d * self.moe_top_k * ff * 3
        return int(total - routed_all + routed_active)
