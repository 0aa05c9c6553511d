"""Plain PyTorch version of weighted federated aggregation."""
from __future__ import annotations

import torch


def fed_agg_ref(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """out[d...] = Σ_c weights[c] · updates[c, d...]   (fp32 accumulate).

    updates: (C, ...) stacked client tensors; weights: (C,).  The CPU
    path of the wrappers and the yardstick the CUDA kernel is held to.
    """
    C = updates.shape[0]
    flat = updates.reshape(C, -1).to(torch.float32)
    out = (flat * weights.to(torch.float32)[:, None]).sum(0)
    return out.reshape(updates.shape[1:]).to(updates.dtype)
