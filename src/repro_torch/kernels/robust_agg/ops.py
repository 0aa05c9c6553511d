"""Robust reductions over the packed (C, D) aggregation buffer.

``geometric_median`` is the smoothed Weiszfeld iteration (RFA, Pillutla
et al. arXiv 1912.13445) built from two primitives per step: the
per-client residual norms (``residual_norms``) and the weighted sum
(``repro_torch.kernels.fed_agg``).  On a CUDA tensor under
``impl="cuda"`` each is one launch of its hand-written kernel; a tensor on
the CPU has no kernel to run and takes the plain versions.
``impl="torch"`` is the plain version on either device.  The iteration
count is fixed: no convergence test, nothing read back to the host.

The client-sharded variants (``*_sharded``) belong to ROADMAP Queue A #17
(multi-device).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fed_agg.ops import fed_agg_packed
from repro_torch.kernels.robust_agg.kernel import residual_norms_cuda
from repro_torch.kernels.robust_agg.ref import (residual_norms_ref,
                                                trimmed_mean)

IMPLS = ("cuda", "torch")
TINY = 1e-30

__all__ = ["residual_norms", "geometric_median", "trimmed_mean",
           "masked_median"]


def residual_norms(updates: torch.Tensor, center: torch.Tensor, *,
                   impl: str = "cuda") -> torch.Tensor:
    """dist_c = ||u_c - z||_2 over a packed (C, D) buffer -> (C,) fp32."""
    if impl not in IMPLS:
        raise ValueError(f"unknown robust_agg impl: {impl!r} "
                         f"(expected one of {IMPLS})")
    if impl == "torch" or updates.device.type == "cpu":
        return residual_norms_ref(updates, center)
    return residual_norms_cuda(updates, center)


def _weiszfeld_step(updates, w, z, *, eps, impl, block_c, block_d):
    """One smoothed Weiszfeld reweighting."""
    dist = residual_norms(updates, z, impl=impl)
    beta = torch.where(w > 0, w / dist.clamp_min(eps), 0.0)
    return fed_agg_packed(updates, beta / beta.sum().clamp_min(TINY),
                          impl=impl, block_c=block_c, block_d=block_d)


def geometric_median(updates: torch.Tensor, weights: torch.Tensor, *,
                     iters: int = 6, eps: float = 1e-6, impl: str = "cuda",
                     block_c: int = 8, block_d: int = 2048) -> torch.Tensor:
    """Smoothed Weiszfeld geometric median of (C, D) rows -> (D,) fp32.

    ``weights`` are the (unnormalized) aggregation weights — zero rows
    (clients that did not report) never influence the iteration.  The
    init point is the weighted mean, so ``iters=0`` is the mean path.
    ``block_c`` / ``block_d`` are the ``fed_agg`` kernel's tile knobs.
    """
    w = weights.float()
    u = updates.float().contiguous()
    z = fed_agg_packed(u, w / w.sum().clamp_min(TINY), impl=impl,
                       block_c=block_c, block_d=block_d)
    for _ in range(int(iters)):
        z = _weiszfeld_step(u, w, z, eps=eps, impl=impl, block_c=block_c,
                            block_d=block_d)
    return z


def masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Lower median of ``x`` over ``valid`` entries (0.0 when none)."""
    m = valid.sum()
    order = torch.sort(torch.where(valid, x, torch.inf)).values
    i = ((m - 1) // 2).clamp(0, x.shape[0] - 1)
    # gather, not order[i]: indexing by a 0-d tensor reads it to the host
    return torch.where(m > 0, order.gather(0, i.reshape(1))[0], 0.0)
