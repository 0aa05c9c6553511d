"""Oracles and plain PyTorch versions of the robust aggregation rules.

``geometric_median_ref`` and ``trimmed_mean_ref`` are the reference's
float64 numpy oracles, copied: the smoothed Weiszfeld iteration of RFA
(Pillutla et al., arXiv 1912.13445, Algorithm 1) with a fixed iteration
count, and the coordinate-wise trimmed mean over the valid (weight > 0)
clients.

Beside them, the plain PyTorch versions: ``residual_norms_ref`` (the CPU
path of ``ops.residual_norms`` and the yardstick the CUDA kernel is held
to), ``geometric_median_torch`` (the Weiszfeld loop on those plain
reductions, which the card's kernel-driven loop is held to) and
``trimmed_mean`` (the rule itself: it has no kernel).
"""
from __future__ import annotations

import numpy as np
import torch

TINY = 1e-30


def geometric_median_ref(updates: np.ndarray, weights: np.ndarray,
                         iters: int = 6, eps: float = 1e-6) -> np.ndarray:
    """Smoothed Weiszfeld over (C, D) rows -> (D,).  float64 accumulate."""
    u = np.asarray(updates, np.float64)
    w = np.asarray(weights, np.float64)
    z = (w / max(w.sum(), TINY)) @ u
    for _ in range(int(iters)):
        dist = np.linalg.norm(u - z[None, :], axis=1)
        beta = np.where(w > 0, w / np.maximum(dist, eps), 0.0)
        z = (beta / max(beta.sum(), TINY)) @ u
    return z


def trimmed_mean_ref(updates: np.ndarray, weights: np.ndarray,
                     trim: float = 0.2) -> np.ndarray:
    """Coordinate-wise weighted trimmed mean over (C, D) rows -> (D,)."""
    u = np.asarray(updates, np.float64)
    w = np.asarray(weights, np.float64)
    valid = w > 0
    m = int(valid.sum())
    if m == 0:
        return np.zeros(u.shape[1])
    k = min(int(np.floor(trim * m + 1e-6)), max((m - 1) // 2, 0))
    out = np.zeros(u.shape[1])
    for d in range(u.shape[1]):
        col = u[valid, d]
        wv = w[valid]
        order = np.argsort(col, kind="stable")
        keep = order[k:m - k]
        out[d] = (wv[keep] @ col[keep]) / max(wv[keep].sum(), TINY)
    return out


def residual_norms_ref(updates: torch.Tensor,
                       center: torch.Tensor) -> torch.Tensor:
    """dist_c = ||u_c - z||_2 over (C, D) rows -> (C,) fp32."""
    return torch.linalg.vector_norm(
        updates.float() - center.float()[None], dim=1)


def geometric_median_torch(updates: torch.Tensor, weights: torch.Tensor,
                           iters: int = 6, eps: float = 1e-6
                           ) -> torch.Tensor:
    """Smoothed Weiszfeld of (C, D) rows -> (D,) fp32, plain PyTorch."""
    u = updates.float()
    w = weights.float()
    z = (w / w.sum().clamp_min(TINY)) @ u
    for _ in range(int(iters)):
        dist = residual_norms_ref(u, z)
        beta = torch.where(w > 0, w / dist.clamp_min(eps), 0.0)
        z = (beta / beta.sum().clamp_min(TINY)) @ u
    return z


def trimmed_mean(updates: torch.Tensor, weights: torch.Tensor, *,
                 trim: float = 0.2) -> torch.Tensor:
    """Coordinate-wise weighted trimmed mean of (C, D) rows -> (D,) fp32.

    Per coordinate, the ``k = floor(trim * m)`` smallest and largest
    values among the ``m`` valid (weight > 0) clients are dropped and the
    survivors average with their weights (``k`` is capped so at least one
    row always survives).  Ranks come from a stable sort over the client
    axis, invalid rows keyed +inf so they rank last, as in the reference.
    """
    u = updates.float()
    w = weights.float()
    valid = w > 0
    m = valid.sum()
    k = torch.minimum(torch.floor(trim * m + 1e-6).to(torch.int64),
                      ((m - 1) // 2).clamp_min(0))
    key = torch.where(valid[:, None], u, torch.inf)
    order = torch.argsort(key, dim=0, stable=True)
    # the inverse permutation of each column: its rank
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(u.shape[0], device=u.device)[:, None]
        .expand_as(order))
    keep = valid[:, None] & (ranks >= k) & (ranks < m - k)
    wk = w[:, None] * keep
    return (wk * u).sum(0) / wk.sum(0).clamp_min(TINY)
