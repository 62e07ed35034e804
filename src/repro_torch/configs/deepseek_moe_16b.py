"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066; hf].  28L d_model=2048 16H (kv=16) d_ff=1408
vocab=102400."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=1408, vocab_size=102400,
    moe=True, num_experts=64, num_shared_experts=2, moe_top_k=6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=32, vocab_size=256,
        moe=True, num_experts=8, num_shared_experts=2, moe_top_k=2,
        dtype="float32",
    )
