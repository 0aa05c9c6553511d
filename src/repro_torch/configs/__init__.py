"""Config registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

The port of ``repro.configs``: the same 11 configurations, kept as the
port's own copies of the reference's data files."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    EncDecConfig,
    FLConfig,
    HybridConfig,
    INPUT_SHAPES,
    InputShape,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SSMConfig,
    TrainConfig,
    VisionStubConfig,
)

from repro_torch.configs.h2o_danube_1p8b import CONFIG as _h2o
from repro_torch.configs.zamba2_1p2b import CONFIG as _zamba2
from repro_torch.configs.phi3_vision_4p2b import CONFIG as _phi3v
from repro_torch.configs.deepseek_v2_236b import CONFIG as _dsv2
from repro_torch.configs.nemotron_4_340b import CONFIG as _nemotron
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.llama3_405b import CONFIG as _llama3
from repro_torch.configs.flude_paper import CONFIG as _flude_paper

_REGISTRY = {
    c.name: c
    for c in [
        _h2o, _zamba2, _phi3v, _dsv2, _nemotron,
        _qwen2, _whisper, _rwkv6, _mixtral, _llama3, _flude_paper,
    ]
}

ASSIGNED_ARCHS = [
    "h2o-danube-1.8b", "zamba2-1.2b", "phi-3-vision-4.2b", "deepseek-v2-236b",
    "nemotron-4-340b", "qwen2-7b", "whisper-large-v3", "rwkv6-7b",
    "mixtral-8x7b", "llama3-405b",
]


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    return sorted(_REGISTRY)


# the training driver's scales (repro/launch/train.py SCALES): a scale
# replaces an arch's widths and trains it in fp32
SCALES = {
    # ~100M-param config for the end-to-end driver (paper kind: training)
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 d_ff=3072, vocab_size=32000, head_dim=64),
    "10m": dict(num_layers=6, d_model=384, num_heads=6, num_kv_heads=2,
                d_ff=1536, vocab_size=8192, head_dim=64),
}


def scaled_config(name: str, scale=None) -> ModelConfig:
    """``get_config(name)``, at one of ``SCALES`` if ``scale`` names it, as
    the training driver builds its model (``--arch``, ``--scale``)."""
    cfg = get_config(name)
    if scale:
        cfg = dataclasses.replace(
            cfg, name=f"{cfg.name}-{scale}", param_dtype="float32",
            compute_dtype="float32", **SCALES[scale])
    return cfg


__all__ = [
    "ASSIGNED_ARCHS", "EncDecConfig", "FLConfig", "HybridConfig",
    "INPUT_SHAPES", "InputShape", "MLAConfig", "ModelConfig", "MoEConfig",
    "RWKVConfig", "SSMConfig", "TrainConfig", "VisionStubConfig",
    "SCALES", "get_config", "list_configs", "scaled_config",
]
