"""C4 — staleness-aware model distribution (paper §4.3, Eq. 4).

Selected devices split into:
  U — completed last participation (or never selected): always get the
      fresh global model;
  V — failed last participation and hold a local cache: get the fresh model
      only if their cache staleness exceeds the adaptive threshold W.

Threshold adaptation (Eq. 4):
  W'  = W_old · (1 − λ·(H_new − H_old)/H_old)      — staleness pressure
  W   = W'   · (1 + μ·(N_new − N_old)/N_old)       — comm-cost pressure
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DistributorState(NamedTuple):
    w_threshold: torch.Tensor   # 0-d float32 — W
    h_old: torch.Tensor         # 0-d — previous average staleness
    n_old: torch.Tensor         # 0-d — previous distribution count


class DistributionPlan(NamedTuple):
    distribute: torch.Tensor    # (N,) bool — S_distr (receive fresh global)
    resume: torch.Tensor        # (N,) bool — train from local cache
    state: DistributorState     # updated threshold state
    avg_staleness: torch.Tensor


def init_distributor(w_init: float = 3.0, device="cpu") -> DistributorState:
    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=device)
    return DistributorState(f32(w_init), f32(0.0), f32(1.0))


def plan_distribution(state: DistributorState, selected: torch.Tensor,
                      in_v: torch.Tensor, has_cache: torch.Tensor,
                      staleness: torch.Tensor, *, lam: float, mu: float,
                      w_min: float, w_max: float,
                      mode: str = "adaptive") -> DistributionPlan:
    """Decide who receives the fresh global model this round.

    selected:  (N,) bool — S (Algorithm 1 output)
    in_v:      (N,) bool — failed their last participation
    has_cache: (N,) bool — hold a valid local cache
    staleness: (N,) float — rounds since their cache was written
    """
    cacheable = selected & in_v & has_cache
    zero = torch.zeros((), dtype=torch.float32, device=selected.device)

    if mode == "full":
        return DistributionPlan(selected, torch.zeros_like(selected),
                                state, zero)
    if mode == "least":
        return DistributionPlan(selected & ~cacheable, cacheable, state,
                                zero)
    if mode != "adaptive":
        raise ValueError(f"unknown distribution mode {mode!r}")

    # --- adaptive (Eq. 4) -------------------------------------------------
    nv = cacheable.sum().clamp_min(1)
    h_new = torch.where(cacheable, staleness, 0.0).sum() / nv

    w_old, h_old, n_old = state
    # first observation (h_old == 0): no staleness pressure yet
    h_ref = torch.where(h_old > 0, h_old, h_new.clamp_min(1e-3))
    delta_h = torch.where(h_old > 0, h_new - h_old, 0.0)
    w_prime = w_old * (1.0 - lam * delta_h / h_ref)
    n_new = (cacheable & (staleness > w_prime)).sum().to(torch.float32)
    n_ref = n_old.clamp_min(1.0)
    w_new = w_prime * (1.0 + mu * (n_new - n_old) / n_ref)
    w_new = torch.clamp(w_new, w_min, w_max)

    too_stale = staleness > w_new
    resume = cacheable & ~too_stale
    distribute = selected & ~resume
    return DistributionPlan(distribute, resume,
                            DistributorState(w_new, h_new, n_new), h_new)


def predicted_comm_cost(distribute: torch.Tensor, selected: torch.Tensor,
                        avg_dependability) -> torch.Tensor:
    """Algorithm 2 line 11: B_pred = |S_distr| + |S| · R̄  (model-transmission
    units: downloads actually sent + uploads expected back)."""
    return (distribute.sum().to(torch.float32)
            + selected.sum().to(torch.float32) * avg_dependability)
