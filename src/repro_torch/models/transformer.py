"""Causal-LM stack: the dense GQA decoder (with or without a sliding window).

The port of the dense path of ``repro.models.transformer``.  Parameters
are nested dicts with the reference's keys, except that ``params
["blocks"]`` is a list with one dict per layer where the reference stacks
the layers on a leading axis (``repro_torch.convert`` unstacks them).
The layers run in a Python loop, eagerly; there is no remat (the slice
serves, it does not train).  Hybrid (zamba2), RWKV, MoE, MLA, vision and
encoder-decoder configs raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L

ATTN_IMPLS = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Runtime execution knobs, field for field as the reference's.

    One documented exception: ``attn_impl`` takes ``"cuda"`` (the default,
    the hand-written Hopper flash-attention kernel) or ``"torch"`` (its
    plain version) in place of ``chunked | dense``.  Every other knob
    keeps its default or raises ``NotImplementedError``: the kernel's
    tiles are fixed (``q_chunk``, ``k_chunk``, ``unroll_causal``), the
    layers run in a Python loop with no remat, as the slice serves and
    does not train (``scan_layers``, ``remat``: ROADMAP Queue A #15e), and
    sharding and MoE dispatch are not ported (#17, #15d)."""
    attn_impl: str = "cuda"          # cuda | torch
    q_chunk: int = 512
    k_chunk: int = 512
    unroll_causal: bool = False
    scan_layers: Optional[bool] = None
    remat: Optional[bool] = None
    seq_shard_resid: bool = False
    moe_groups: int = 1
    moe_dispatch: str = "gather"
    mesh: Any = None
    rules: Any = None

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"ExecConfig.attn_impl must be 'cuda' or "
                             f"'torch', got {self.attn_impl!r}")
        if (self.q_chunk, self.k_chunk, self.unroll_causal) != \
                (512, 512, False):
            raise NotImplementedError(
                "ExecConfig q_chunk, k_chunk and unroll_causal pick the "
                "reference's chunked attention; repro_torch's flash kernel "
                "has fixed 64-row tiles (ROADMAP Queue B #3)")
        if self.scan_layers is not None or self.remat is not None:
            raise NotImplementedError(
                "ExecConfig scan_layers and remat shape the training "
                "forward; repro_torch runs the layers in a Python loop and "
                "does not train yet (ROADMAP Queue A #15e)")
        if self.mesh is not None or self.rules is not None \
                or self.seq_shard_resid:
            raise NotImplementedError(
                "ExecConfig sharding (mesh, rules, seq_shard_resid) is not "
                "ported to repro_torch yet (ROADMAP Queue A #17)")
        if self.moe_groups != 1 or self.moe_dispatch != "gather":
            raise NotImplementedError(
                "ExecConfig MoE dispatch is not ported to repro_torch yet "
                "(ROADMAP Queue A #15d)")


def check_supported(cfg):
    """Raise ``NotImplementedError`` for a config outside the dense GQA
    decoder, naming the ROADMAP Queue A item that ports it."""
    why = None
    if cfg.encdec is not None:
        why = "encoder-decoder models (whisper) are #15d"
    elif cfg.arch_type == "hybrid" or cfg.hybrid is not None:
        why = "hybrid Mamba2 models (zamba2) are #15b"
    elif cfg.rwkv is not None:
        why = "RWKV models are #15c"
    elif cfg.moe is not None:
        why = "MoE models are #15d"
    elif cfg.attention == "mla" or cfg.mla is not None:
        why = "MLA attention is #15d"
    elif cfg.vision is not None:
        why = "vision-language models are #15d"
    elif cfg.attention != "gqa":
        why = f"attention={cfg.attention!r} is not ported"
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: repro_torch serves the dense GQA decoder only; "
            f"{why} in ROADMAP Queue A")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _block_spec(cfg, layered):
    """One decoder block: GQA attention + MLP."""
    return {"norm1": _lnorm(cfg, layered), "norm2": _lnorm(cfg, layered),
            "attn": A.gqa_spec(cfg, layered=layered),
            "mlp": L.mlp_spec(cfg, cfg.d_model, cfg.d_ff, layered=layered)}


def _lnorm(cfg, layered):
    return L.norm_spec(cfg, cfg.d_model, layered=layered)


def build_spec(cfg) -> Dict[str, Any]:
    """The reference's spec tree: ``blocks`` stacked on a leading layer
    axis when ``cfg.scan_layers`` (every config has it)."""
    check_supported(cfg)
    dt = L.cfg_dtype(cfg.param_dtype)
    spec: Dict[str, Any] = {
        "embed": L.ParamSpec((cfg.vocab_size, cfg.d_model), "embed", dt,
                             ("vocab", "embed"), 0.02),
        "final_norm": L.norm_spec(cfg, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = L.ParamSpec((cfg.d_model, cfg.vocab_size),
                                      "normal", dt, ("embed", "vocab"))
    Lr = cfg.num_layers if cfg.scan_layers else None
    spec["blocks"] = _block_spec(cfg, Lr)
    return spec


def layer_spec(blocks_spec, stacked: bool):
    """One layer's spec from the ``blocks`` spec: the leading layer axis
    dropped, the fan-in the stacked leaf had kept."""
    if isinstance(blocks_spec, dict):
        return {k: layer_spec(v, stacked) for k, v in blocks_spec.items()}
    s = blocks_spec
    if not stacked:
        return s
    return dataclasses.replace(
        s, shape=s.shape[1:], axes=None if s.axes is None else s.axes[1:],
        fan_in=s.resolved_fan_in if s.init == "normal" else s.fan_in)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg):
    return params["embed"][tokens].to(L.cfg_dtype(cfg.compute_dtype))


def lm_head(params, x, cfg):
    if cfg.tie_embeddings:
        w = params["embed"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    return x @ w


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def block_forward(p, x, positions, cfg, exec_cfg):
    h = L.apply_norm(p["norm1"], x, cfg)
    x = x + A.gqa_forward(p["attn"], h, positions, cfg,
                          impl=exec_cfg.attn_impl)
    h = L.apply_norm(p["norm2"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h, cfg)


def block_decode(p, x, positions, cfg, cache):
    h = L.apply_norm(p["norm1"], x, cfg)
    o, cache = A.gqa_decode_step(p["attn"], h, positions, cfg, cache)
    x = x + o
    h = L.apply_norm(p["norm2"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h, cfg), cache


def block_prefill(p, x, positions, cfg, cache, exec_cfg):
    h = L.apply_norm(p["norm1"], x, cfg)
    o, cache = A.gqa_prefill(p["attn"], h, positions, cfg, cache,
                             impl=exec_cfg.attn_impl)
    x = x + o
    h = L.apply_norm(p["norm2"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h, cfg), cache


# ---------------------------------------------------------------------------
# Stack (train forward)
# ---------------------------------------------------------------------------

def _positions(batch, tokens):
    B, Sq = tokens.shape
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(Sq, device=tokens.device)[None].expand(B, Sq)
    return pos


def forward(params, batch, cfg, exec_cfg=ExecConfig()):
    """Full forward -> (logits, aux_loss); the auxiliary loss is MoE's
    router loss, 0.0 for the dense stack."""
    check_supported(cfg)
    tokens = batch["tokens"]
    positions = _positions(batch, tokens)
    x = embed_tokens(params, tokens, cfg)
    x = _dense_forward(params, x, positions, cfg, exec_cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return lm_head(params, x, cfg), 0.0


def _dense_forward(params, x, positions, cfg, exec_cfg):
    for p_l in params["blocks"]:
        x = block_forward(p_l, x, positions, cfg, exec_cfg)
    return x


# ---------------------------------------------------------------------------
# Decode (serve) paths
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    layers: List[A.KVCache]   # one cache per layer


def init_cache(cfg, batch: int, max_len: int, *, device="cuda"):
    check_supported(cfg)
    return DecodeCache([A.init_kv_cache(cfg, batch, max_len, device=device)
                        for _ in range(cfg.num_layers)])


def decode_step(params, tokens, positions, cache: DecodeCache, cfg):
    """One-token decode.  tokens: (B, 1); positions: (B, 1) absolute.
    Each layer's cache is updated in place."""
    x = embed_tokens(params, tokens, cfg)
    new = []
    for p_l, c_l in zip(params["blocks"], cache.layers):
        x, c_l = block_decode(p_l, x, positions, cfg, c_l)
        new.append(c_l)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return lm_head(params, x, cfg), DecodeCache(new)


def prefill(params, batch, cfg, exec_cfg=ExecConfig(), max_len=None):
    """Prompt prefill: returns (last-position logits, filled cache).

    ``max_len`` sets the cache capacity (>= prompt length) so subsequent
    decode steps have headroom; defaults to the prompt length."""
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    max_len = max_len or Sq
    positions = _positions(batch, tokens)
    x = embed_tokens(params, tokens, cfg)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    new = []
    for p_l, c_l in zip(params["blocks"], cache.layers):
        x, c_l = block_prefill(p_l, x, positions, cfg, c_l, exec_cfg)
        new.append(c_l)
    x = L.apply_norm(params["final_norm"], x[:, -1:], cfg)
    return lm_head(params, x, cfg), DecodeCache(new)
