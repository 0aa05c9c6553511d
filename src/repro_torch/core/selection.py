"""C2 — adaptive device selection (paper §4.1, Algorithm 1, Eqs. 2–3).

Priority:  P(i) = R(i) · (Q / q_i)^(1(Q < q_i) · σ)       (Eq. 2)
Threshold: Q = Σ_k |S_k| / |A|                            (Eq. 3)

ε-greedy bandit: exploit the top-priority (1-ε)·X explored devices, explore
ε·X among never-explored devices.  Fixed-shape tensor code: the dynamic
counts are rank thresholds, so nothing is read back to the host.

Randomness: the reference draws the explore noise and the Thompson
sample inside the selector (``jax.random.uniform`` / ``jax.random.beta``
of the round's key); here the caller passes the round's (N,) uniforms and
Thompson draws in, so a test can feed both packages the same numbers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.dependability import BetaBelief, dependability

NEG = -1e30


class SelectionResult(NamedTuple):
    selected: torch.Tensor       # (N,) bool — S
    exploited: torch.Tensor      # (N,) bool
    explored_new: torch.Tensor   # (N,) bool — O (newly explored this round)
    priority: torch.Tensor       # (N,) float32 — P(i) (for logging/tests)


def freq_threshold(total_selected, num_devices) -> torch.Tensor:
    """Eq. (3): average per-device frequency under uniform random picks."""
    return total_selected / max(num_devices, 1)


def priority(R: torch.Tensor, part_count: torch.Tensor, Q,
             sigma: float) -> torch.Tensor:
    """Eq. (2) on the dependabilities ``R`` (the posterior mean, or a
    Thompson sample of it).  part_count q_i == 0 never exceeds Q, so the
    factor is 1."""
    q = part_count.to(torch.float32)
    ratio = torch.where(q > 0, Q / q.clamp_min(1e-9), 1.0)
    exceeds = (q > Q).to(torch.float32)
    penalty = torch.pow(ratio.clamp_min(1e-9), exceeds * sigma)
    return R * penalty


def _rank_mask(scores: torch.Tensor, k) -> torch.Tensor:
    """Boolean mask of the top-k scores (``k`` may be a 0-d tensor).

    The reference's ``jnp.argsort`` is stable and ties are common among
    equal beliefs, so the sort here is stable too."""
    order = torch.argsort(-scores, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(scores.shape[0], device=scores.device))
    return (ranks < k) & (scores > NEG / 2)


def select_participants(belief: BetaBelief, part_count: torch.Tensor,
                        explored: torch.Tensor, online: torch.Tensor,
                        total_selected, X, epsilon, sigma: float,
                        uniforms: torch.Tensor,
                        explore_hints: Optional[torch.Tensor] = None,
                        thompson_draws: Optional[torch.Tensor] = None
                        ) -> SelectionResult:
    """Algorithm 1.  ``X`` may be a 0-d tensor (budget-adapted by Alg. 2).

    - exploit (1-ε)·X among explored ∩ online, by priority (Eq. 2)
    - explore ε·X among (not explored) ∩ online — by the round's
      ``uniforms``, or biased by ``explore_hints`` (paper §4.1: higher
      hint ⇒ explored earlier; the uniforms then only break ties)
    - ``thompson_draws``, when given, replace the posterior MEAN in
      Eq. 2 by the round's Thompson sample R(i) ~ Beta(α_i, β_i)
      (``dependability.sample_dependability``) — a beyond-paper variant
      that keeps probing uncertain devices after ε decays
    - if the explore pool is too small, the exploit share absorbs the rest
      (and vice versa), so |S| == min(X, |online|).
    """
    N = online.shape[0]
    Q = freq_threshold(total_selected, N)
    R = dependability(belief) if thompson_draws is None else \
        thompson_draws.to(device=online.device, dtype=torch.float32)
    P = priority(R, part_count, Q, sigma)

    X = torch.minimum(torch.as_tensor(X, device=online.device),
                      online.sum()).to(torch.int32)
    n_explore_want = torch.round(epsilon * X).to(torch.int32)
    pool_explore = ~explored & online
    pool_exploit = explored & online
    n_explore = torch.minimum(n_explore_want, pool_explore.sum())
    n_exploit = torch.minimum(X - n_explore, pool_exploit.sum())
    # re-grow explore if exploit pool was short
    n_explore = torch.minimum(X - n_exploit, pool_explore.sum())

    exploit_scores = torch.where(pool_exploit, P, NEG)
    exploited = _rank_mask(exploit_scores, n_exploit)

    noise = uniforms.to(device=online.device, dtype=torch.float32)
    if explore_hints is not None:
        noise = explore_hints.to(torch.float32) + 0.01 * noise
    explore_scores = torch.where(pool_explore, noise, NEG)
    explored_new = _rank_mask(explore_scores, n_explore)

    return SelectionResult(exploited | explored_new, exploited,
                           explored_new, P)


def decay_epsilon(epsilon, decay: float, floor: float):
    """Paper §5.2: ε ← ε·0.98 while ε > 0.2."""
    return torch.clamp_min(epsilon * decay, floor)
