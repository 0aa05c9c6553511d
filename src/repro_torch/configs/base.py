"""FLUDE hyper-parameters, field for field as ``repro.configs.base.FLConfig``.

One documented exception: ``agg_impl`` takes ``"cuda"`` (the default, the
hand-written Hopper kernel) or ``"torch"`` (its plain version) in place of
``xla | pallas | pallas_interpret``; ``agg_block_c`` / ``agg_block_d`` are
the CUDA kernel's tile knobs.  Values the port does not run yet raise
``NotImplementedError`` naming the ROADMAP Queue A item that ports them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


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
    cohort_size: Optional[int] = None
    cache_offload: Optional[str] = None
    cache_staleness_bound: int = 32
    dynamics: str = "bernoulli_host"
    dynamics_params: Tuple[Tuple[str, Any], ...] = ()
    pipeline_depth: int = 1
    telemetry: Optional[str] = None
    debug_checks: bool = False

    def __post_init__(self):
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
        if self.selection_mode != "mean":
            _not_ported("selection_mode", "#8 (baseline policies)")
        if self.agg_rule != "mean" or self.agg_rule_params:
            _not_ported("agg_rule", "#11 (robust aggregation)")
        if self.adversary is not None:
            _not_ported("adversary", "#11 (robust aggregation and "
                        "adversaries)")
        if self.dynamics != "bernoulli_host" or self.dynamics_params:
            _not_ported("dynamics", "#9 (device dynamics loop)")
        if self.pipeline_depth > 1:
            _not_ported("pipeline_depth", "#9 (device dynamics loop)")
        if self.cohort_size is not None:
            _not_ported("cohort_size", "#10 (compact cohorts)")
        if self.cache_offload is not None:
            _not_ported("cache_offload", "#12 (host cache offload)")
        if self.telemetry is not None:
            _not_ported("telemetry", "#13 (telemetry)")
        if self.debug_checks:
            _not_ported("debug_checks", "#14 (invariant checks)")
        if self.mesh_shape is not None:
            _not_ported("mesh_shape", "#17 (multi-device)")
        if self.donate_buffers:
            _not_ported("donate_buffers", "#17 (multi-device: mesh and "
                        "memory)")
