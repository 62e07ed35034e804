"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060;
unverified].  48L d_model=2048 (attn-free) d_ff=0 vocab=50280 ssm_state=128.
Vocab padded 50280 → 50288 for 16-way sharding divisibility."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    head_dim=0, d_ff=0, vocab_size=50288,
    ssm=True, ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        num_layers=3, d_model=64, num_heads=0, num_kv_heads=0,
        head_dim=0, d_ff=0, vocab_size=256,
        ssm=True, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        dtype="float32",
    )
