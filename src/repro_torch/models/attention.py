"""Attention substrate: GQA (+ sliding window, qkv bias) and its KV cache.

The port of the GQA part of ``repro.models.attention``.

Layouts
-------
q:      (B, S, Hkv, G, D)   — G = query-group size = Hq // Hkv
k, v:   (B, S, Hkv, D)
cache:  KVCache with k/v of (B, S_cache, Hkv, D) (ring-buffered for SWA)

The full-sequence core (train / prefill) is
``repro_torch.kernels.flash_attention``: the hand-written CUDA kernel on
the card under ``impl="cuda"``, its plain version under ``impl="torch"``
or on the CPU.  The reference computes the same contract in plain JAX
(``chunked_attention``).  Decode attention is plain PyTorch on the ring
cache, as the reference's is plain JAX.  MLA is ROADMAP Queue A #15d.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.ops import \
    flash_attention_model_layout
from repro_torch.models import layers as L

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_cache, Hkv, D)
    v: torch.Tensor          # (B, S_cache, Hkv, D)
    length: torch.Tensor     # (B,) valid prefix length (== insert position)


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def gqa_spec(cfg, layered: Optional[int] = None):
    d, hk = cfg.d_model, cfg.num_kv_heads
    g = cfg.num_heads // hk
    hd = cfg.resolved_head_dim
    dt = L.cfg_dtype(cfg.param_dtype)

    def w(shape, axes, init="normal", scale=1.0, fan_in=None):
        if layered is not None:
            shape = (layered,) + shape
            axes = ("layers",) + axes
        return L.ParamSpec(shape, init, dt, axes, scale, fan_in=fan_in)

    # explicit fan_in: the shape heuristic reads dim -2, which for these
    # multi-dim projections is a head axis, not the contraction size
    p = {
        "wq": w((d, hk, g, hd), ("embed", "kv_heads", "q_group", "head_dim"),
                fan_in=d),
        "wk": w((d, hk, hd), ("embed", "kv_heads", "head_dim"), fan_in=d),
        "wv": w((d, hk, hd), ("embed", "kv_heads", "head_dim"), fan_in=d),
        "wo": w((hk, g, hd, d), ("kv_heads", "q_group", "head_dim", "embed"),
                fan_in=hk * g * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = w((hk, g, hd), ("kv_heads", "q_group", "head_dim"), "zeros")
        p["bk"] = w((hk, hd), ("kv_heads", "head_dim"), "zeros")
        p["bv"] = w((hk, hd), ("kv_heads", "head_dim"), "zeros")
    return p


# ---------------------------------------------------------------------------
# GQA block forward
# ---------------------------------------------------------------------------

def _project_qkv(p, x, cfg):
    dt = x.dtype
    B, S, d = x.shape
    hk, g, hd = p["wq"].shape[1:]
    q = (x @ p["wq"].to(dt).reshape(d, -1)).reshape(B, S, hk, g, hd)
    k = (x @ p["wk"].to(dt).reshape(d, -1)).reshape(B, S, hk, hd)
    v = (x @ p["wv"].to(dt).reshape(d, -1)).reshape(B, S, hk, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _rope_qk(q, k, positions, cfg):
    q = L.apply_rope(q.reshape(q.shape[:2] + (-1, q.shape[-1])),
                     positions, cfg.rope_theta).reshape(q.shape)
    return q, L.apply_rope(k, positions, cfg.rope_theta)


def _out_proj(p, o, x):
    B, S = o.shape[:2]
    wo = p["wo"].to(x.dtype)
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def gqa_forward(p, x, positions, cfg, *, causal: bool = True,
                impl: str = "cuda"):
    """Full-sequence attention (train / encoder / prefill).

    x: (B, S, d); positions: (B, S) absolute positions."""
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    o = flash_attention_model_layout(
        q, k, v, causal=causal, window=cfg.sliding_window,
        scale=cfg.resolved_head_dim ** -0.5, impl=impl)
    return _out_proj(p, o, x)


def gqa_prefill(p, x, positions, cfg, cache: KVCache, *,
                impl: str = "cuda"):
    """Prefill: run full attention AND fill the cache.

    ``cache`` is fresh (``init_kv_cache``), so it is written in place."""
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    o = flash_attention_model_layout(
        q, k, v, causal=True, window=cfg.sliding_window,
        scale=cfg.resolved_head_dim ** -0.5, impl=impl)
    out = _out_proj(p, o, x)
    S = x.shape[1]
    Sc = cache.k.shape[1]
    if Sc >= S:
        cache.k[:, :S] = k
        cache.v[:, :S] = v
    else:   # ring cache smaller than prompt (SWA): keep the tail, placed
        # at ring index p mod Sc (decode's slotting discipline)
        cache.k.copy_(torch.roll(k[:, S - Sc:], S % Sc, dims=1))
        cache.v.copy_(torch.roll(v[:, S - Sc:], S % Sc, dims=1))
    return out, KVCache(cache.k, cache.v, torch.full_like(cache.length, S))


def gqa_decode_step(p, x, positions, cfg, cache: KVCache):
    """One-token decode: x (B, 1, d), positions (B, 1) absolute.

    The cache is a ring buffer of size S_cache; for SWA archs S_cache ==
    sliding_window.  The new key and value are written into ``cache`` in
    place (the reference donates the cache to its jitted step)."""
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)

    B = k.shape[0]
    Sc = cache.k.shape[1]
    rows = torch.arange(B, device=x.device)
    slot = (cache.length % Sc).long()
    cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)

    slot_idx = torch.arange(Sc, device=x.device)[None, :]     # (1, Sc)
    n_written = torch.clamp(cache.length[:, None] + 1, max=Sc)
    wrapped = (cache.length[:, None] + 1) > Sc
    valid = wrapped | (slot_idx < n_written)                  # (B, Sc)

    # scores in fp32 from the model-dtype q (preferred_element_type=f32)
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     (q * cfg.resolved_head_dim ** -0.5).float(),
                     cache.k.to(q.dtype).float())
    s = torch.where(valid[:, None, None, None], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", prob.to(cache.v.dtype),
                     cache.v.to(q.dtype))
    o = o.permute(0, 3, 1, 2, 4)
    out = _out_proj(p, o, x)
    return out, KVCache(cache.k, cache.v, cache.length + 1)


def init_kv_cache(cfg, batch: int, max_len: int, *, device="cuda"):
    """An empty cache: ``max_len`` slots, or the window's for SWA."""
    Sc = max_len if cfg.sliding_window is None else min(
        max_len, cfg.sliding_window)
    dt = L.cfg_dtype(cfg.param_dtype)
    hd = cfg.resolved_head_dim
    shape = (batch, Sc, cfg.num_kv_heads, hd)
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device), length)
