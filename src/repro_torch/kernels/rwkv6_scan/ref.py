"""Plain PyTorch oracle: the exact WKV6 recurrence in kernel layout
(B, H, S, D).

The port of ``repro.kernels.rwkv6_scan.ref.rwkv6_scan_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor,
                   s0: Optional[torch.Tensor] = None):
    """r, k, v, logw: (B, H, S, D); u: (H, D); s0: (B, H, D, D) fp32.

    y_t = r_t · (S_{t-1} + diag(u)·k_t v_tᵀ);  S_t = diag(w_t)·S_{t-1}
                                                     + k_t v_tᵀ
    Returns y (B, H, S, D) fp32 and the final state."""
    B, H, S, D = r.shape
    state = torch.zeros((B, H, D, D), dtype=torch.float32,
                        device=r.device) if s0 is None else s0.float()
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float())
    uf = u.float()
    ys = []
    for t in range(S):
        rt, kt, vt, wt = rf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t]
        a = torch.einsum("bhi,bhj->bhij", kt, vt)
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               state + uf[None, :, :, None] * a))
        state = wt[..., None] * state + a
    y = torch.stack(ys, 2) if ys else rf.new_zeros((B, H, 0, D))
    return y, state
