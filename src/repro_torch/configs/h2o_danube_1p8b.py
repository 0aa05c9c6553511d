"""h2o-danube-1.8b — dense, llama+mistral mix with sliding-window attention.

[arXiv:2401.16818] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    arch_type="dense",
    source="arXiv:2401.16818",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    head_dim=80,
    attention="gqa",
    sliding_window=4096,       # mistral-style SWA
    mlp_act="silu_glu",
    rope_theta=10000.0,
)
