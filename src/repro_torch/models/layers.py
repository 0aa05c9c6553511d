"""Parameter specs and initialisation of the port's models.

The part of ``repro.models.layers`` the FL classifier needs: the
fan-in-scaled normal law and zeros.  Values come from an explicit
``torch.Generator`` on the CPU, so one seed gives the same parameters on
every device; they follow the reference's law, not its numbers (JAX draws
threefry bits — a test that needs the reference's numbers hands them over
with ``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal (fan-in scaled) | zeros


def _init_one(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=torch.float32)
    if spec.init != "normal":
        raise ValueError(f"unknown init law {spec.init!r}")
    fan_in = spec.shape[0] if len(spec.shape) >= 2 \
        else max(spec.shape[-1], 1)
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.randn(spec.shape, generator=gen, dtype=torch.float32) * std


def init_params(specs: dict, gen: torch.Generator,
                device="cpu") -> dict:
    """Materialise a nested dict of ``ParamSpec`` on ``device``, drawing the
    leaves in sorted key order (the reference's tree order)."""
    out = {}
    for k in sorted(specs):
        v = specs[k]
        out[k] = init_params(v, gen, device) if isinstance(v, dict) \
            else _init_one(v, gen).to(device)
    return out
