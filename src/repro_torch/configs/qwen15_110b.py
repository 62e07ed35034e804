"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].
80L d_model=8192 64H (kv=8) d_ff=49152 vocab=152064.  FSDP (params + opt
state sharded over "data" as well) — 110B does not fit TP-only on v5e."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=49152, vocab_size=152064,
    qkv_bias=True, fsdp=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=8, num_kv_heads=2,
        head_dim=8, d_ff=128, vocab_size=256, qkv_bias=True,
        dtype="float32",
    )
