"""whisper-small [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified].  12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865 (padded → 51872).  input_specs() supplies precomputed
conv-frontend frames (B, 1500, d_model).  12 heads don't divide the 16-way
model axis → attn_head_tp=False.  Whisper's semantic decoder context is 448;
we still lower the assigned decode shapes at the stated cache lengths
(DESIGN.md §5)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    head_dim=64, d_ff=3072, vocab_size=51872,
    enc_dec=True, enc_layers=12, enc_frames=1500,
    attn_head_tp=False,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256,
        enc_dec=True, enc_layers=2, enc_frames=32, attn_head_tp=False,
        dtype="float32",
    )
