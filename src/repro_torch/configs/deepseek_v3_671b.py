"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8
[arXiv:2412.19437; hf].  61L d_model=7168 128H d_ff=2048 vocab=129280.

Simplifications vs. the HF checkpoint (noted in DESIGN.md): all 61 layers are
MoE (v3 uses 3 dense lead-in layers); MTP head omitted; aux-free routing
bias replaced by a Switch-style balance loss.  FSDP — 671B params need
param+opt sharding over both mesh axes."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    head_dim=128, d_ff=2048, vocab_size=129280,
    moe=True, num_experts=256, num_shared_experts=1, moe_top_k=8,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
    v_head_dim=128, fsdp=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=32, vocab_size=256,
        moe=True, num_experts=8, num_shared_experts=1, moe_top_k=2,
        use_mla=True, q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
        v_head_dim=16, dtype="float32",
    )
