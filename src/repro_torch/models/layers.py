"""Shared model substrate: param specs, norms, MLPs, rotary embeddings.

The port of ``repro.models.layers``.  Parameters are described by
``ParamSpec`` trees (shape, dtype, logical axes, init law) and
materialised by ``init_params``.  Values come from an explicit
``torch.Generator`` and are drawn on its device (a CPU generator for the
FL classifier, so one seed gives the same parameters on every device; a
CUDA generator for a language model at full width); they follow the
reference's law, not its numbers (JAX draws threefry bits — a test that
needs the reference's numbers hands them over with ``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | zeros | ones | embed
    dtype: torch.dtype = torch.float32
    axes: Optional[Tuple[Optional[str], ...]] = None   # logical axis names
    scale: float = 1.0                # multiplier on the default fan-in scale
    fan_in: Optional[int] = None      # explicit fan-in (contraction size);
                                      # None = shape heuristic (2D/stacked-3D)

    def __post_init__(self):
        assert self.axes is None or len(self.axes) == len(self.shape), \
            (self.shape, self.axes)

    @property
    def resolved_fan_in(self) -> int:
        if self.fan_in is not None:
            return self.fan_in
        if len(self.shape) >= 3:       # stacked/layered weights: dim -2
            return self.shape[-2]
        return self.shape[0] if len(self.shape) >= 2 \
            else max(self.shape[-1], 1)


def _init_one(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "embed":
        std = 1.0 * spec.scale
    elif spec.init == "normal":       # fan-in scaled normal
        std = spec.scale / math.sqrt(max(spec.resolved_fan_in, 1))
    else:
        raise ValueError(f"unknown init law {spec.init!r}")
    return (torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=dev) * std).to(spec.dtype)


def init_params(specs: dict, gen: torch.Generator, device=None) -> dict:
    """Materialise a nested dict of ``ParamSpec``, drawing the leaves in
    sorted key order (the reference's tree order) on the generator's
    device, then placing them on ``device`` (default: stay there)."""
    out = {}
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            out[k] = init_params(v, gen, device)
        else:
            x = _init_one(v, gen)
            out[k] = x if device is None else x.to(device)
    return out


def spec_leaves(specs):
    """The ``ParamSpec`` leaves of a spec tree, in sorted key order."""
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            yield from spec_leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_spec(cfg, d: int, layered: Optional[int] = None):
    shape, axes = (d,), ("embed",)
    if layered is not None:
        shape, axes = (layered, d), ("layers", "embed")
    dt = cfg_dtype(cfg.param_dtype)
    p = {"scale": ParamSpec(shape, "ones", dt, axes)}
    if cfg.norm == "layernorm":
        p["bias"] = ParamSpec(shape, "zeros", dt, axes)
    return p


def apply_norm(p, x, cfg, eps: float = 1e-5):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def cfg_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------

def dense_spec(cfg, din: int, dout: int, axes, *, bias: bool = False,
               layered: Optional[int] = None, scale: float = 1.0,
               init: str = "normal"):
    dt = cfg_dtype(cfg.param_dtype)
    shape, ax = (din, dout), tuple(axes)
    if layered is not None:
        shape, ax = (layered, din, dout), ("layers",) + tuple(axes)
    out = {"w": ParamSpec(shape, init, dt, ax, scale)}
    if bias:
        bshape = (dout,) if layered is None else (layered, dout)
        bax = (axes[-1],) if layered is None else ("layers", axes[-1])
        out["b"] = ParamSpec(bshape, "zeros", dt, bax)
    return out


def apply_dense(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def mlp_spec(cfg, d: int, d_ff: int, layered: Optional[int] = None,
             in_axis: str = "embed", ff_axis: str = "mlp"):
    p = {"wi": dense_spec(cfg, d, d_ff, (in_axis, ff_axis), layered=layered)}
    if cfg.mlp_act == "silu_glu":
        p["wg"] = dense_spec(cfg, d, d_ff, (in_axis, ff_axis),
                             layered=layered)
    p["wo"] = dense_spec(cfg, d_ff, d, (ff_axis, in_axis), layered=layered)
    return p


def apply_mlp(p, x, cfg):
    if cfg.mlp_act == "silu_glu":
        h = F.silu(apply_dense(p["wi"], x)) * apply_dense(p["wg"], x)
    elif cfg.mlp_act == "gelu":       # jax.nn.gelu's default: tanh form
        h = F.gelu(apply_dense(p["wi"], x), approximate="tanh")
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(apply_dense(p["wi"], x)))
    else:
        raise ValueError(cfg.mlp_act)
    return apply_dense(p["wo"], h)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    """numpy float32, as the reference computes them: a float64 or torch
    ``pow`` gives other last bits at theta = 1e6."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=None)
def _rope_table(head_dim: int, theta: float, device: torch.device):
    """``rope_freqs`` placed on ``device`` once: a copy from pageable host
    memory on every call would synchronise the stream each layer."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates
    the two halves of each vector (not interleaved pairs)."""
    d = x.shape[-1]
    freqs = _rope_table(d, theta, x.device)              # (D/2,)
    angles = positions[..., None].float() * freqs        # (..., S, D/2)
    angles = angles[..., None, :]                        # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
