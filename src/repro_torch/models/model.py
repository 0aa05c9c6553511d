"""Model API of the causal LMs the port serves (dense GQA, the zamba2
hybrid, RWKV6).

The port of ``repro.models.model.Model`` for the configs the port serves
(``transformer.check_supported``); the dry-run specs (``input_specs``,
``abstract_params``) wait for ROADMAP Queue A #16.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


class Model:
    """Functional model handle: specs + apply functions over a param dict."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs = T.build_spec(cfg)

    # -- params ------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Draw the parameters on ``gen``'s device by the reference's init
        laws: the top-level leaves in sorted key order, then each layered
        tree (``blocks``; the hybrid's ``mamba`` and ``mamba_norm``) layer
        by layer into a list of per-layer dicts."""
        top = {k: v for k, v in self.specs.items() if k not in T.LAYERED}
        params = L.init_params(top, gen)
        for k, one in T.layered_specs(self.cfg, self.specs).items():
            params[k] = [L.init_params(one, gen)
                         for _ in range(self.cfg.num_layers)]
        return params

    def param_count(self) -> int:
        """From the specs alone: nothing is allocated."""
        return int(sum(math.prod(s.shape)
                       for s in L.spec_leaves(self.specs)))

    # -- steps ---------------------------------------------------------------
    def loss(self, params, batch, exec_cfg=T.ExecConfig(),
             per_example: bool = False):
        return T.lm_loss(params, batch, self.cfg, exec_cfg,
                         per_example=per_example)

    def logits(self, params, batch, exec_cfg=T.ExecConfig()):
        return T.forward(params, batch, self.cfg, exec_cfg)[0]

    def prefill(self, params, batch, exec_cfg=T.ExecConfig(),
                max_len=None):
        return T.prefill(params, batch, self.cfg, exec_cfg, max_len=max_len)

    def decode_step(self, params, tokens, positions, cache):
        return T.decode_step(params, tokens, positions, cache, self.cfg)

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        return T.init_cache(self.cfg, batch, max_len, device=device)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
