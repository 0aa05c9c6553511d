"""mixtral-8x7b — sparse MoE, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    source="arXiv:2401.04088",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    attention="gqa",
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, num_shared_experts=0,
                  expert_d_ff=14336, capacity_factor=1.25),
    mlp_act="silu_glu",
    rope_theta=1000000.0,
)
