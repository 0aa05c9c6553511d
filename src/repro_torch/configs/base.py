"""Configs of the port, field for field as ``repro.configs.base``.

``ModelConfig`` with its sub-configs, ``InputShape`` / ``INPUT_SHAPES``,
``TrainConfig`` and ``FLConfig``; ``MeshConfig`` comes with the
multi-device slice (ROADMAP Queue A #17).

``FLConfig`` has one documented exception: ``agg_impl`` takes ``"cuda"``
(the default, the hand-written Hopper kernel) or ``"torch"`` (its plain
version) in place of ``xla | pallas | pallas_interpret``; ``agg_block_c``
/ ``agg_block_d`` are the ``fed_agg`` kernel's tile knobs.  ``agg_rule``,
``adversary`` and ``dynamics`` must name a rule, an attack and an
availability process of the port's registries (``ValueError``
otherwise).  Values the port does not run yet raise
``NotImplementedError`` naming the ROADMAP Queue A item that ports them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from repro_torch.core.agg_rules import available_agg_rules
from repro_torch.fleet.adversary import available_adversaries
from repro_torch.fleet.api import available_dynamics


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    expert_d_ff: Optional[int] = None      # d_ff of each routed expert
    shared_d_ff: Optional[int] = None      # d_ff of the shared expert(s)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block config."""
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk_size: int = 256
    n_groups: int = 1          # B/C groups (like GQA for SSM)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora_rank: int = 64
    gate_lora_rank: int = 64
    token_shift: bool = True


@dataclass(frozen=True)
class HybridConfig:
    """zamba2-style hybrid: Mamba2 backbone + shared attention block."""
    attn_every: int = 6        # apply the shared attention block every N layers
    shared_attn_blocks: int = 1


@dataclass(frozen=True)
class EncDecConfig:
    """whisper-style encoder-decoder."""
    num_encoder_layers: int = 32
    num_decoder_layers: int = 32
    max_target_len: int = 448


@dataclass(frozen=True)
class VisionStubConfig:
    """VLM frontend stub: precomputed patch embeddings are model inputs."""
    num_image_tokens: int = 1024   # patch tokens prepended to the sequence
    patch_embed_dim: int = 1024    # CLIP-style embed dim before projector


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    source: str                        # citation (arXiv id / hf model card)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default: d_model // num_heads
    # attention flavour
    attention: str = "gqa"             # gqa | mla | none (attention-free)
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    # mlp flavour
    mlp_act: str = "silu_glu"          # silu_glu | gelu | relu2
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    tie_embeddings: bool = False
    # family-specific blocks
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vision: Optional[VisionStubConfig] = None
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # scan/remat
    scan_layers: bool = True
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized variant of the same family (<=2 layers etc.)."""
        changes = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            head_dim=64,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                expert_d_ff=min(self.moe.expert_d_ff or self.d_ff, 256),
                shared_d_ff=min(self.moe.shared_d_ff or self.d_ff, 256),
            )
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32,
                qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
            changes["head_dim"] = None
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk_size=32)
        if self.rwkv is not None:
            changes["rwkv"] = dataclasses.replace(
                self.rwkv, head_dim=32, decay_lora_rank=16, gate_lora_rank=16)
        if self.hybrid is not None:
            changes["hybrid"] = dataclasses.replace(self.hybrid, attn_every=2)
            changes["num_layers"] = 4
        if self.encdec is not None:
            changes["encdec"] = dataclasses.replace(
                self.encdec, num_encoder_layers=2, num_decoder_layers=2,
                max_target_len=16)
        if self.vision is not None:
            changes["vision"] = dataclasses.replace(
                self.vision, num_image_tokens=8, patch_embed_dim=64)
        if self.sliding_window is not None:
            changes["sliding_window"] = 16
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


# ---------------------------------------------------------------------------
# Train / FL configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    optimizer: str = "adamw"           # sgd | momentum | adam | adamw
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # Adam m/v dtype (bf16 for >=200B)
    accum_dtype: str = "float32"       # microbatch grad accumulator dtype
    microbatch_size: Optional[int] = None   # per-silo microbatch for grad accum
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"FLConfig.{what} is not ported to repro_torch yet (ROADMAP "
        f"Queue A {item}); the port runs the default FLUDE main path")


@dataclass(frozen=True)
class FLConfig:
    """FLUDE hyper-parameters (paper §5.2 defaults)."""
    num_clients: int = 256
    clients_per_round: int = 32
    local_steps: int = 4
    # selection (Alg. 1)
    selection_mode: str = "mean"       # mean | thompson (beyond-paper)
    epsilon_init: float = 0.9          # exploration factor
    epsilon_decay: float = 0.98
    epsilon_min: float = 0.2
    sigma: float = 0.5                 # frequency penalty exponent
    # dependability prior (Eq. 1)
    beta_alpha0: float = 2.0
    beta_beta0: float = 2.0
    # staleness distribution (Eq. 4)
    lam: float = 1.0                   # λ — staleness coefficient
    mu: float = 0.5                    # μ — comm-cost coefficient
    w_init: float = 3.0                # initial staleness threshold
    w_min: float = 1.0
    w_max: float = 50.0
    # round process (Alg. 2)
    comm_budget: float = float("inf")  # B_max, in model-transmission units
    round_deadline: float = 600.0      # T, seconds (simulator wall clock)
    # caching (C3)
    cache_enabled: bool = True
    base_cache_interval: float = 60.0  # seconds between cache writes
    distribution_mode: str = "adaptive"  # adaptive | full | least
    # server aggregation (§4.3 hot path): packed whole-model kernel
    staleness_discount: float = 1.0    # per-round decay of stale-base weights
    agg_impl: str = "cuda"             # cuda | torch
    agg_block_c: int = 8               # client-chunk granularity of the kernel
    agg_block_d: int = 2048            # columns per CUDA block (256..2048)
    agg_rule: str = "mean"
    agg_rule_params: Tuple[Tuple[str, Any], ...] = ()
    adversary: Optional[str] = None
    adversary_params: Tuple[Tuple[str, Any], ...] = ()
    mesh_shape: Optional[Tuple[int, ...]] = None
    donate_buffers: bool = False
    # compact cohorts: a static X runs each device-loop round over the
    # selected clients' (X, ...) rows instead of all N
    cohort_size: Optional[int] = None
    # None | "host" (the (N, D) C3 cache params live in a host store, the
    # card keeps (N,) metadata and the round's (X, D) block) | "discard"
    # ("host", and rows older than cache_staleness_bound rounds dropped)
    cache_offload: Optional[str] = None
    cache_staleness_bound: int = 32
    dynamics: str = "bernoulli_host"
    dynamics_params: Tuple[Tuple[str, Any], ...] = ()
    pipeline_depth: int = 1
    telemetry: Optional[str] = None
    # ^ default device-metrics level of engine runs (repro_torch.obs).
    #   None builds nothing: the round path runs the same ops and reads
    #   as an uninstrumented engine.  "basic" adds the participation,
    #   loss, time and cache counters; "full" also the update and
    #   residual norms (through the fed_agg and residual_norms kernels),
    #   the trust quantiles and the staleness histogram.  The values
    #   ride the round ledger's read-back: no added wait for the card.
    #   ``FleetEngine.run(telemetry=...)`` overrides it per run.
    debug_checks: bool = False
    # ^ runtime sanitizers (repro_torch.analysis.runtime): after each
    #   server step a guard checks that the global model and the losses
    #   are finite and the cohort index in range, read once a round
    #   through ``host_readback``; at run end a detector checks that no
    #   memoised round function was rebuilt by a repeat run.  A
    #   debugging mode: it waits for the card once a round.

    def __post_init__(self):
        if self.telemetry not in (None, "basic", "full"):
            raise ValueError(
                f"FLConfig.telemetry must be None, 'basic' or 'full', "
                f"got {self.telemetry!r}")
        if self.selection_mode not in ("mean", "thompson"):
            raise ValueError(
                f"FLConfig.selection_mode must be 'mean' or 'thompson', "
                f"got {self.selection_mode!r}")
        if self.agg_impl not in ("cuda", "torch"):
            raise ValueError(f"FLConfig.agg_impl must be 'cuda' or 'torch', "
                             f"got {self.agg_impl!r}")
        b = self.cache_staleness_bound
        if not isinstance(b, int) or isinstance(b, bool) or b < 1:
            raise ValueError(
                f"FLConfig.cache_staleness_bound must be a positive int, "
                f"got {b!r}")
        if self.pipeline_depth < 1:
            raise ValueError(f"FLConfig.pipeline_depth must be >= 1, got "
                             f"{self.pipeline_depth}")
        if self.agg_rule not in available_agg_rules():
            raise ValueError(
                f"FLConfig.agg_rule must be a registered agg rule "
                f"({', '.join(available_agg_rules())}), got "
                f"{self.agg_rule!r}")
        if self.adversary is not None \
                and self.adversary not in available_adversaries():
            raise ValueError(
                f"FLConfig.adversary must be a registered adversary "
                f"({', '.join(available_adversaries())}) or None, "
                f"got {self.adversary!r}")
        if self.dynamics not in available_dynamics():
            raise ValueError(
                f"FLConfig.dynamics must be a registered dynamics "
                f"process ({', '.join(available_dynamics())}), got "
                f"{self.dynamics!r}")
        if self.cache_offload not in (None, "host", "discard"):
            raise ValueError(
                f"FLConfig.cache_offload must be None, 'host' or "
                f"'discard', got {self.cache_offload!r}")
        if self.cache_offload is not None and self.cohort_size is None:
            raise ValueError(
                f"FLConfig.cache_offload={self.cache_offload!r} requires "
                f"cohort_size — only the compact cohort path knows which "
                f"(X, D) cache slots a round touches; set cohort_size or "
                f"keep cache_offload=None for the resident pytree")
        x = self.cohort_size
        if x is not None:
            if not isinstance(x, int) or isinstance(x, bool) or x < 1:
                raise ValueError(
                    f"FLConfig.cohort_size must be a positive int or None, "
                    f"got {x!r}")
            if x > self.num_clients:
                raise ValueError(
                    f"FLConfig.cohort_size ({x}) exceeds num_clients "
                    f"({self.num_clients}) — a cohort cannot be larger "
                    f"than the fleet; use cohort_size=None for the full "
                    f"scan")
        if self.mesh_shape is not None:
            _not_ported("mesh_shape", "#17 (multi-device)")
        if self.donate_buffers:
            _not_ported("donate_buffers", "#17 (multi-device: mesh and "
                        "memory)")
