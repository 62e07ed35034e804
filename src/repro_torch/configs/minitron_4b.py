"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679; hf].
32L d_model=3072 24H (kv=8) d_ff=9216 vocab=256000.

24 heads do not divide the 16-way "model" axis → attn_head_tp=False: the
attention block runs with model-axis-replicated weights (the baseline the
§Perf minitron hillclimb attacks)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    head_dim=128, d_ff=9216, vocab_size=256000,
    attn_head_tp=False,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke", family="dense",
        num_layers=3, d_model=48, num_heads=6, num_kv_heads=2,
        head_dim=8, d_ff=96, vocab_size=512, attn_head_tp=False,
        dtype="float32",
    )
