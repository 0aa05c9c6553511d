"""zamba2-1.2b — hybrid: Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242] 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  The single shared attention+MLP block is applied every
``attn_every`` Mamba2 layers (weight sharing across applications).
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    attention="gqa",
    mlp_act="gelu",
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_kernel=4,
                  chunk_size=256),
    hybrid=HybridConfig(attn_every=6, shared_attn_blocks=1),
)
