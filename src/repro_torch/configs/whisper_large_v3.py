"""whisper-large-v3 — encoder-decoder audio model (conv frontend stubbed).

[arXiv:2212.04356] 32L(enc)+32L(dec) d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866.  The mel-spectrogram + conv feature extractor is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, S, d_model).
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="audio",
    source="arXiv:2212.04356",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    attention="gqa",
    mlp_act="gelu",
    norm="layernorm",
    encdec=EncDecConfig(num_encoder_layers=32, num_decoder_layers=32,
                        max_target_len=448),
)
