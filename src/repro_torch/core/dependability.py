"""C1 — device dependability assessment (paper §4.1, Eq. 1).

Each device's probability of successfully completing a training round is
a Beta(α, β) posterior updated by Bayes' rule on observed
successes/failures:

    α_new = α + s,   β_new = β + f,   E[R(i)] = α_new / (α_new + β_new)

The fleet posterior is a pair of (N,) float32 tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class BetaBelief(NamedTuple):
    alpha: torch.Tensor     # (N,) float32
    beta: torch.Tensor      # (N,) float32


def init_belief(num_devices: int, alpha0: float = 2.0, beta0: float = 2.0,
                device="cpu") -> BetaBelief:
    """Neutral prior Beta(2, 2) — "neither dependable nor undependable"."""
    return BetaBelief(
        torch.full((num_devices,), alpha0, dtype=torch.float32,
                   device=device),
        torch.full((num_devices,), beta0, dtype=torch.float32,
                   device=device))


def update_belief(belief: BetaBelief, successes: torch.Tensor,
                  failures: torch.Tensor) -> BetaBelief:
    """Eq. (1): add per-device success/failure counts (int or bool)."""
    return BetaBelief(belief.alpha + successes.to(torch.float32),
                      belief.beta + failures.to(torch.float32))


def dependability(belief: BetaBelief) -> torch.Tensor:
    """E[R(i)] = α / (α + β)  — the per-device dependability estimate."""
    return belief.alpha / (belief.alpha + belief.beta)



def sample_dependability(belief: BetaBelief,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Thompson sample R(i) ~ Beta(α_i, β_i) on the belief's device (the
    optional selection variant).

    Beta(α, β) = Ga(α) / (Ga(α) + Ga(β)) from two standard Gamma draws of
    ``generator`` (``torch.distributions.Beta`` takes none), so a seeded
    generator on the card reproduces its draws."""
    ga = torch._standard_gamma(belief.alpha, generator=generator)
    gb = torch._standard_gamma(belief.beta, generator=generator)
    return ga / (ga + gb)
