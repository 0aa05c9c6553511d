"""Plain PyTorch oracle: the per-timestep Mamba2 SSD recurrence (exact,
sequential).

The port of ``repro.kernels.ssm_scan.ref.ssm_scan_ref``:

    h_t = exp(dt_t · A_h) · h_{t-1} + dt_t · x_t ⊗ B_t ;   y_t = C_t · h_t
"""
from __future__ import annotations

from typing import Optional

import torch


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 h0: Optional[torch.Tensor] = None):
    """x: (B, H, S, P); dt: (B, H, S); A: (H,) negative;
    Bm, Cm: (B, H, S, N) (groups pre-expanded to heads).
    Returns y (B, H, S, P) fp32 and the final state (B, H, P, N) fp32."""
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    Af = A.float()
    ys = []
    for t in range(S):
        dtt = dtf[:, :, t]                                    # (B, H)
        da = torch.exp(dtt * Af[None, :])
        h = da[..., None, None] * h + torch.einsum(
            "bhp,bhn->bhpn", xf[:, :, t] * dtt[..., None], Bf[:, :, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, :, t]))
    y = torch.stack(ys, 2) if ys else xf.new_zeros((B, H, 0, P))
    return y, h
