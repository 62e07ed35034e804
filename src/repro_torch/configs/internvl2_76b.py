"""internvl2-76b [vlm] — InternViT + InternLM2 backbone
[arXiv:2404.16821; unverified].  80L d_model=8192 64H (kv=8) d_ff=28672
vocab=128256.  The ViT frontend is a STUB per the brief: input_specs()
supplies precomputed patch embeddings (B, 1024, d_model) that are prepended
to the text tokens."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=28672, vocab_size=128256,
    vlm_patches=1024, fsdp=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, vlm_patches=8,
        dtype="float32",
    )
