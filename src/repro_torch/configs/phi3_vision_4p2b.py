"""phi-3-vision-4.2b — VLM: phi3-mini backbone + CLIP frontend (stub).

[hf:microsoft/Phi-3-vision-128k-instruct] 32L d_model=3072 32H (GQA kv=32)
d_ff=8192 vocab=32064.  The vision encoder is a STUB: ``input_specs()``
provides precomputed patch embeddings; the projector + language backbone are
fully implemented.
"""
from repro_torch.configs.base import ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    attention="gqa",
    mlp_act="silu_glu",
    vision=VisionStubConfig(num_image_tokens=1024, patch_embed_dim=1024),
)
