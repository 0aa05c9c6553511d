"""Causal-LM stacks: the dense GQA decoder (with or without a sliding
window), the zamba2 hybrid (Mamba2 + one shared attention block) and RWKV6.

The port of the dense, hybrid and RWKV paths of
``repro.models.transformer``.  Parameters are nested dicts with the
reference's keys, except that each tree the reference stacks on a leading
layer axis (``blocks``; the hybrid's ``mamba`` and ``mamba_norm``) is a
list with one dict per layer (``repro_torch.convert`` unstacks them).
The layers run in a Python loop, eagerly; under remat (``cfg.remat``,
or ``ExecConfig.remat``) each block of the training forward runs under
``torch.utils.checkpoint``, so its activations are recomputed in the
backward, as the reference's ``jax.remat`` does.  ``lm_loss`` is the
next-token cross entropy the training step differentiates.  MoE, MLA,
vision and encoder-decoder configs raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as SSM

ATTN_IMPLS = ("cuda", "torch")
# the parameter trees the reference stacks on a leading layer axis and the
# port keeps as per-layer lists: blocks (when cfg.scan_layers), and the
# hybrid's Mamba2 layers and their norms (always)
LAYERED = ("blocks", "mamba", "mamba_norm")


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Runtime execution knobs, field for field as the reference's.

    One documented exception: ``attn_impl`` takes ``"cuda"`` (the
    default) or ``"torch"`` in place of ``chunked | dense``, and picks
    every hand-written kernel of a prefill or forward, not only the
    attention's.  ``"cuda"`` runs, on a CUDA tensor, the Hopper
    flash-attention kernel and the Mamba2 SSD and WKV6 scan kernels
    (``kernels.flash_attention``, ``kernels.ssm_scan``,
    ``kernels.rwkv6_scan``); on a CPU tensor, which has no kernel to run,
    it runs the plain versions.  ``"torch"`` runs the plain versions on
    either device: flash's plain attention and the reference model's own
    scan forms, ``_ssd_chunked`` at ``cfg.ssm.chunk_size`` and
    ``wkv_chunked`` (S > 64) or ``wkv_recurrence``.  Decode steps are
    plain PyTorch under both, as the reference's are plain JAX.  Every
    other knob is read as the reference reads it, keeps its default or
    raises ``NotImplementedError``: ``remat`` (None: ``cfg.remat``) runs
    each block of the training forward under
    ``torch.utils.checkpoint(use_reentrant=False)``; ``scan_layers`` is
    taken and changes no number, as the port's layers are a Python loop
    either way; the kernel's tiles are fixed (``q_chunk``, ``k_chunk``,
    ``unroll_causal``), and sharding and MoE dispatch are not ported
    (#17, #15d)."""
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
                "has fixed tiles (128 query rows in the bf16 wgmma "
                "variant, 64 in the fp32 SIMT one) and takes no chunk "
                "sizes (ROADMAP Queue B #3)")
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
    decoder, the zamba2 hybrid and RWKV6, naming the ROADMAP Queue A item
    that ports it."""
    why = None
    if cfg.encdec is not None:
        why = "encoder-decoder models (whisper) are #15d"
    elif cfg.moe is not None:
        why = "MoE models are #15d"
    elif cfg.attention == "mla" or cfg.mla is not None:
        why = "MLA attention is #15d"
    elif cfg.vision is not None:
        why = "vision-language models are #15d"
    elif cfg.rwkv is None and cfg.attention != "gqa":
        why = f"attention={cfg.attention!r} is not ported"
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: repro_torch serves the dense GQA decoder, the "
            f"zamba2 hybrid and RWKV6 only; {why} in ROADMAP Queue A")


def _wkv_kernel(exec_cfg, x):
    """``time_mix``'s kernel hook: the WKV6 kernel on a CUDA tensor under
    ``attn_impl="cuda"``, else None (the reference's plain forms)."""
    return wkv_kernel_adapter("cuda") if exec_cfg.attn_impl == "cuda" \
        and x.device.type != "cpu" else None


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
    axis when ``cfg.scan_layers`` (every config has it); the hybrid's
    ``mamba`` and ``mamba_norm`` always stacked, its one ``shared_attn``
    block not; RWKV's pre-embedding norm ``ln0``."""
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
    if cfg.arch_type == "hybrid":
        spec["mamba_norm"] = L.norm_spec(cfg, cfg.d_model,
                                         layered=cfg.num_layers)
        spec["mamba"] = SSM.ssm_spec(cfg, layered=cfg.num_layers)
        spec["shared_attn"] = {
            "norm1": _lnorm(cfg, None),
            "attn": A.gqa_spec(cfg, layered=None),
            "norm2": _lnorm(cfg, None),
            "mlp": L.mlp_spec(cfg, cfg.d_model, cfg.d_ff),
        }
    elif cfg.rwkv is not None:
        spec["blocks"] = {
            "norm1": _lnorm(cfg, Lr), "norm2": _lnorm(cfg, Lr),
            "rwkv": R.rwkv_spec(cfg, layered=Lr),
        }
        spec["ln0"] = L.norm_spec(cfg, cfg.d_model)   # pre-embedding LN
    else:
        spec["blocks"] = _block_spec(cfg, Lr)
    return spec


def layered_specs(cfg, specs) -> Dict[str, Any]:
    """One layer's spec of each tree of ``LAYERED`` that ``specs`` holds."""
    return {k: layer_spec(specs[k], k != "blocks" or cfg.scan_layers)
            for k in LAYERED if k in specs}


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
    router loss, 0.0 for the stacks the port runs."""
    check_supported(cfg)
    tokens = batch["tokens"]
    positions = _positions(batch, tokens)
    x = embed_tokens(params, tokens, cfg)
    if cfg.arch_type == "hybrid":
        x = _hybrid_forward(params, x, positions, cfg, exec_cfg)
    elif cfg.rwkv is not None:
        x = _rwkv_forward(params, x, cfg, exec_cfg)
    else:
        x = _dense_forward(params, x, positions, cfg, exec_cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return lm_head(params, x, cfg), 0.0


def _remat(cfg, exec_cfg) -> bool:
    return cfg.remat if exec_cfg.remat is None else exec_cfg.remat


def _run(fn, *args, remat: bool):
    """``fn(*args)``, under activation checkpointing when ``remat`` and a
    gradient is being recorded (the reference's ``jax.remat``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _dense_forward(params, x, positions, cfg, exec_cfg):
    remat = _remat(cfg, exec_cfg)
    for p_l in params["blocks"]:
        x = _run(block_forward, p_l, x, positions, cfg, exec_cfg,
                 remat=remat)
    return x


def _hybrid_segments(cfg):
    """zamba2 layer plan: the shared attention block runs before layers
    0, k, 2k, ... (k = ``attn_every``); returns the [lo, hi) Mamba2 layer
    ranges that follow each application."""
    k = cfg.hybrid.attn_every
    bounds = list(range(0, cfg.num_layers, k)) + [cfg.num_layers]
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def _shared_attn_block(p, x, positions, cfg, exec_cfg):
    h = L.apply_norm(p["norm1"], x, cfg)
    x = x + A.gqa_forward(p["attn"], h, positions, cfg,
                          impl=exec_cfg.attn_impl)
    h = L.apply_norm(p["norm2"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h, cfg)


def _mamba_layer(p, norm, x, cfg, exec_cfg):
    h = L.apply_norm(norm, x, cfg)
    return x + SSM.ssm_forward(p, h, cfg, impl=exec_cfg.attn_impl)


def _hybrid_forward(params, x, positions, cfg, exec_cfg):
    remat = _remat(cfg, exec_cfg)
    for lo, hi in _hybrid_segments(cfg):
        x = _run(_shared_attn_block, params["shared_attn"], x, positions,
                 cfg, exec_cfg, remat=remat)
        for i in range(lo, hi):
            x = _run(_mamba_layer, params["mamba"][i],
                     params["mamba_norm"][i], x, cfg, exec_cfg, remat=remat)
    return x


def _rwkv_forward(params, x, cfg, exec_cfg):
    x = L.apply_norm(params["ln0"], x, cfg)
    kernel = _wkv_kernel(exec_cfg, x)
    remat = _remat(cfg, exec_cfg)
    for p_l in params["blocks"]:
        x = _run(lambda p, x: R.rwkv_block(p["rwkv"], x, cfg, p["norm1"],
                                           p["norm2"], kernel=kernel),
                 p_l, x, remat=remat)
    return x


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss(params, batch, cfg, exec_cfg=ExecConfig(),
            per_example: bool = False):
    """Next-token CE.  labels < 0 are masked.  Returns (loss, metrics).

    The log-softmax is fp32; the label's log-probability is picked with a
    gather (the reference's iota-compare serves a vocab axis sharded over
    a mesh, which the port has not)."""
    logits, aux = forward(params, batch, cfg, exec_cfg)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    lp = torch.log_softmax(logits.float(), dim=-1)
    ll = lp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    if per_example:
        tok = mask.sum(-1).clamp_min(1.0)
        ce = -(ll * mask).sum(-1) / tok                  # (B,)
        return ce.mean() + aux, {"ce_per_example": ce, "aux": aux}
    denom = mask.sum().clamp_min(1.0)
    ce = -(ll * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * mask).sum() / denom
    return ce + aux, {"ce": ce, "aux": aux, "acc": acc}


# ---------------------------------------------------------------------------
# Decode (serve) paths
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    layers: List[Any]        # one per layer: KVCache (dense), SSMState
                             # (hybrid) or RWKVState
    extra: Optional[List[A.KVCache]] = None   # hybrid: one KV cache per
                                              # shared-attention application


def init_cache(cfg, batch: int, max_len: int, *, device="cuda"):
    check_supported(cfg)
    if cfg.arch_type == "hybrid":
        return DecodeCache(
            [SSM.init_ssm_state(cfg, batch, device=device)
             for _ in range(cfg.num_layers)],
            [A.init_kv_cache(cfg, batch, max_len, device=device)
             for _ in _hybrid_segments(cfg)])
    if cfg.rwkv is not None:
        return DecodeCache([R.init_rwkv_state(cfg, batch, device=device)
                            for _ in range(cfg.num_layers)])
    return DecodeCache([A.init_kv_cache(cfg, batch, max_len, device=device)
                        for _ in range(cfg.num_layers)])


def decode_step(params, tokens, positions, cache: DecodeCache, cfg):
    """One-token decode.  tokens: (B, 1); positions: (B, 1) absolute.
    KV caches are updated in place; the recurrent states are replaced."""
    x = embed_tokens(params, tokens, cfg)
    if cfg.arch_type == "hybrid":
        x, cache = _hybrid_decode(params, x, positions, cache, cfg)
    elif cfg.rwkv is not None:
        x, cache = _rwkv_decode(params, x, cache, cfg)
    else:
        new = []
        for p_l, c_l in zip(params["blocks"], cache.layers):
            x, c_l = block_decode(p_l, x, positions, cfg, c_l)
            new.append(c_l)
        cache = DecodeCache(new)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return lm_head(params, x, cfg), cache


def _hybrid_decode(params, x, positions, cache, cfg):
    sa = params["shared_attn"]
    new_ssm, new_attn = [], []
    for si, (lo, hi) in enumerate(_hybrid_segments(cfg)):
        h = L.apply_norm(sa["norm1"], x, cfg)
        o, attn_c = A.gqa_decode_step(sa["attn"], h, positions, cfg,
                                      cache.extra[si])
        x = x + o
        h = L.apply_norm(sa["norm2"], x, cfg)
        x = x + L.apply_mlp(sa["mlp"], h, cfg)
        new_attn.append(attn_c)
        for i in range(lo, hi):
            h = L.apply_norm(params["mamba_norm"][i], x, cfg)
            o, st = SSM.ssm_decode_step(params["mamba"][i], h, cfg,
                                        cache.layers[i])
            x = x + o
            new_ssm.append(st)
    return x, DecodeCache(new_ssm, new_attn)


def _rwkv_decode(params, x, cache, cfg):
    x = L.apply_norm(params["ln0"], x, cfg)
    new = []
    for p_l, st in zip(params["blocks"], cache.layers):
        h = L.apply_norm(p_l["norm1"], x, cfg)
        tm, wkv = R.time_mix(p_l["rwkv"], h, cfg, st)
        x = x + tm
        h2 = L.apply_norm(p_l["norm2"], x, cfg)
        x = x + R.channel_mix(p_l["rwkv"], h2, st)
        new.append(R.RWKVState(h[:, -1], h2[:, -1], wkv, st.length + 1))
    return x, DecodeCache(new)


def prefill(params, batch, cfg, exec_cfg=ExecConfig(), max_len=None):
    """Prompt prefill: returns (last-position logits, filled cache).

    ``max_len`` sets the KV cache capacity (>= prompt length) so
    subsequent decode steps have headroom; defaults to the prompt length.
    The recurrent states of the hybrid and RWKV stacks have no length."""
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    max_len = max_len or Sq
    positions = _positions(batch, tokens)
    x = embed_tokens(params, tokens, cfg)
    if cfg.arch_type == "hybrid":
        x, cache = _hybrid_prefill(params, x, positions, cfg, exec_cfg,
                                   max_len)
    elif cfg.rwkv is not None:
        x, cache = _rwkv_prefill(params, x, cfg, exec_cfg)
    else:
        cache = init_cache(cfg, B, max_len, device=tokens.device)
        new = []
        for p_l, c_l in zip(params["blocks"], cache.layers):
            x, c_l = block_prefill(p_l, x, positions, cfg, c_l, exec_cfg)
            new.append(c_l)
        cache = DecodeCache(new)
    x = L.apply_norm(params["final_norm"], x[:, -1:], cfg)
    return lm_head(params, x, cfg), cache


def _hybrid_prefill(params, x, positions, cfg, exec_cfg, max_len):
    sa = params["shared_attn"]
    ssm_states, attn_caches = [], []
    for lo, hi in _hybrid_segments(cfg):
        c0 = A.init_kv_cache(cfg, x.shape[0], max_len, device=x.device)
        h = L.apply_norm(sa["norm1"], x, cfg)
        o, c = A.gqa_prefill(sa["attn"], h, positions, cfg, c0,
                             impl=exec_cfg.attn_impl)
        x = x + o
        h = L.apply_norm(sa["norm2"], x, cfg)
        x = x + L.apply_mlp(sa["mlp"], h, cfg)
        attn_caches.append(c)
        for i in range(lo, hi):
            h = L.apply_norm(params["mamba_norm"][i], x, cfg)
            o, st = SSM.ssm_forward(params["mamba"][i], h, cfg,
                                    return_state=True,
                                    impl=exec_cfg.attn_impl)
            x = x + o
            ssm_states.append(st)
    return x, DecodeCache(ssm_states, attn_caches)


def _rwkv_prefill(params, x, cfg, exec_cfg):
    x = L.apply_norm(params["ln0"], x, cfg)
    kernel = _wkv_kernel(exec_cfg, x)
    states = []
    for p_l in params["blocks"]:
        x, st = R.rwkv_block(p_l["rwkv"], x, cfg, p_l["norm1"],
                             p_l["norm2"], return_state=True, kernel=kernel)
        states.append(st)
    return x, DecodeCache(states)
