"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].  81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000 ssm_state=64.  The shared attention+MLP block's params are
reused every 6 layers (13 application points, each with its own KV cache)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    head_dim=112, d_ff=14336, vocab_size=32000,
    ssm=True, ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    hybrid_attn_every=6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=7, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256,
        ssm=True, ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
        hybrid_attn_every=3, dtype="float32",
    )
