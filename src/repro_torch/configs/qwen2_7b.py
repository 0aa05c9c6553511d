"""qwen2-7b — dense GQA with QKV bias.

[arXiv:2407.10671] 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    arch_type="dense",
    source="arXiv:2407.10671",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    attention="gqa",
    qkv_bias=True,
    mlp_act="silu_glu",
    rope_theta=1000000.0,
)
