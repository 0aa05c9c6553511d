"""flude-paper — the paper's own training regime, transformer-ized.

The paper trains small CNNs (5-layer CNN / VGG-9 / ResNet-18 / 4x conv1d /
WideAndDeep) on 120 edge devices.  Our substrate is transformer-family; this
config is the ~paper-scale stand-in used by the cross-device FL examples and
benchmarks (a few-M-params causal LM; classification benchmarks use
``repro.fl.classifier`` instead).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="flude-paper",
    arch_type="dense",
    source="this paper (§5.2)",
    num_layers=4,
    d_model=256,
    num_heads=8,
    num_kv_heads=4,
    d_ff=1024,
    vocab_size=4096,
    head_dim=32,
    attention="gqa",
    mlp_act="silu_glu",
    param_dtype="float32",
    compute_dtype="float32",
)
