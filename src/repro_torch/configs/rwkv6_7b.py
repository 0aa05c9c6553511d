"""rwkv6-7b (Finch) — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 32L d_model=4096 d_ff=14336 vocab=65536.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=4096,
    num_heads=64,              # 4096 / head_dim 64
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
    attention="none",
    mlp_act="relu2",           # rwkv channel-mix uses squared relu
    norm="layernorm",
    rwkv=RWKVConfig(head_dim=64, decay_lora_rank=64, gate_lora_rank=64),
)
