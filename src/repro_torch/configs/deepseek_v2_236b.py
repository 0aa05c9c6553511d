"""deepseek-v2-236b — MoE with Multi-head Latent Attention.

[arXiv:2405.04434] 60L d_model=5120 128H d_ff=1536(expert) vocab=102400,
MLA kv_lora=512, 2 shared + 160 routed experts, top-6.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # MLA decompresses to per-head K/V (MHA-like)
    d_ff=12288,                # dense-equivalent ff (first layer is dense in
                               # DeepSeek-V2; we keep all layers MoE for
                               # uniform scan, noting the delta in DESIGN.md)
    vocab_size=102400,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, num_shared_experts=2,
                  expert_d_ff=1536, shared_d_ff=1536, capacity_factor=1.25),
    mlp_act="silu_glu",
)
