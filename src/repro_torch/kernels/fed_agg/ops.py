"""Public wrappers of weighted federated aggregation.

``impl="cuda"`` launches the hand-written Hopper kernel on a CUDA tensor;
a tensor on the CPU has no kernel to run and takes the plain version.
``impl="torch"`` is the plain version on either device, the reference the
kernel is held to.  The kernel has no backward: on a CUDA tensor under
grad, with an input that requires it, ``impl="cuda"`` raises
``NotImplementedError`` (``kernels/grad.py``).  The client-sharded variant
(``fed_agg_packed_sharded``) belongs to ROADMAP Queue A #17 (multi-device).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fed_agg.kernel import fed_agg_cuda
from repro_torch.kernels.fed_agg.ref import fed_agg_ref
from repro_torch.kernels.grad import SERVER_STEP_ONLY, refuse_grad

IMPLS = ("cuda", "torch")


def fed_agg_packed(updates: torch.Tensor, weights: torch.Tensor, *,
                   impl: str = "cuda", block_c: int = 8,
                   block_d: int = 2048) -> torch.Tensor:
    """Σ_c w_c · u_c over an already-packed (C, D) buffer -> (D,).

    The packed buffer holds every leaf of a stacked client model
    (``repro_torch.core.aggregation.pack_stacked``), so one call
    aggregates the whole model."""
    if impl not in IMPLS:
        raise ValueError(f"unknown fed_agg impl: {impl!r} "
                         f"(expected one of {IMPLS})")
    if impl == "torch" or updates.device.type == "cpu":
        return fed_agg_ref(updates, weights)
    refuse_grad("fed_agg cuda", updates, weights, why=SERVER_STEP_ONLY)
    return fed_agg_cuda(updates, weights, block_c=block_c, block_d=block_d)


def fed_agg(updates: torch.Tensor, weights: torch.Tensor, *,
            impl: str = "cuda", block_c: int = 8,
            block_d: int = 2048) -> torch.Tensor:
    """Σ_c w_c · u_c for one stacked tensor (C, ...) -> (...)."""
    C = updates.shape[0]
    out = fed_agg_packed(updates.reshape(C, -1), weights, impl=impl,
                         block_c=block_c, block_d=block_d)
    return out.reshape(updates.shape[1:]).to(updates.dtype)
