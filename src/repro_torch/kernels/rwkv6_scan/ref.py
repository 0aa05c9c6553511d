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
    Returns y (B, H, S, D) fp32 and the final state (float64 for float64
    r, to check a gradient against)."""
    B, H, S, D = r.shape
    f = torch.float64 if r.dtype == torch.float64 else torch.float32
    state = torch.zeros((B, H, D, D), dtype=f,
                        device=r.device) if s0 is None else s0.to(f)
    rf, kf, vf, uf = (t.to(f) for t in (r, k, v, u))
    wf = torch.exp(logw.to(f))
    ys = []
    for t in range(S):
        rt, kt, vt, wt = rf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t]
        a = torch.einsum("bhi,bhj->bhij", kt, vt)
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               state + uf[None, :, :, None] * a))
        state = wt[..., None] * state + a
    y = torch.stack(ys, 2) if ys else rf.new_zeros((B, H, 0, D))
    return y, state


def rwkv6_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor, u: torch.Tensor,
                       s0: Optional[torch.Tensor], dy: torch.Tensor,
                       dsf: Optional[torch.Tensor] = None):
    """The gradient of ``rwkv6_scan_ref`` in the order the backward kernel
    (``csrc/rwkv6_scan_bwd.cu``) takes it: a plain mirror of its walks,
    for checking the algebra on the CPU.  Nothing on the card's path
    calls it.

    Shapes as ``rwkv6_scan_ref``; ``dy`` (B, H, S, D), ``dsf`` (B, H, D,
    D) or None (zeros).  Computes in r's dtype (float32 or float64).
    Returns dr, dk, dv, dlogw, du (H, D) and ds0 (B, H, D, D).

    With G_t = dL/dS_t, G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ (G_S = dS_f)
    and c_t = v_t·dy_t:
        dr_t = S_{t-1} dy_t + u ∘ k_t c_t,
        dk_t = G_t v_t + r_t ∘ u c_t,
        dv_t = G_tᵀ k_t + (Σ_i r_ti u_i k_ti) dy_t,
        du = Σ_t r_t ∘ k_t c_t,   ds0 = G_0,
        dlogw_t = Σ_{τ>t} ρ_τ + rowsum(dS_f ∘ S_f) − Σ_{s≥t} κ_s,
    with ρ_τ = r_τ ∘ (S_{τ-1} dy_τ) and κ_s = k_s ∘ (G_s v_s): the two
    reverse cumulative sums, so that no walk needs S_{t-1} and G_t at
    once.  The forward walk carries S and forms dr, ρ and du; the reverse
    walk carries G (rows for dk and the running dlogw sum, columns for
    dv in the kernel; one tensor here)."""
    Bsz, H, S, D = r.shape
    f = r.dtype
    w = torch.exp(logw.to(f))
    u = u.to(f)
    st = torch.zeros((Bsz, H, D, D), dtype=f, device=r.device) \
        if s0 is None else s0.to(f)
    c = (v * dy).sum(-1)                                     # (B,H,S)
    a = (r * u[None, :, None] * k).sum(-1)
    dr, rho = torch.zeros_like(r), torch.zeros_like(r)
    du = torch.zeros((Bsz, H, D), dtype=f, device=r.device)
    for t in range(S):                                       # forward walk
        sdy = torch.einsum("bhij,bhj->bhi", st, dy[:, :, t])
        dr[:, :, t] = sdy + u * k[:, :, t] * c[:, :, t, None]
        rho[:, :, t] = r[:, :, t] * sdy
        du = du + r[:, :, t] * k[:, :, t] * c[:, :, t, None]
        st = w[:, :, t, :, None] * st \
            + k[:, :, t, :, None] * v[:, :, t, None, :]
    g = torch.zeros_like(st) if dsf is None else dsf.to(f)
    run = (g * st).sum(-1)                                   # rowsum(dS_f ∘ S_f)
    dk, dv, dlogw = (torch.zeros_like(r) for _ in range(3))
    for t in reversed(range(S)):                             # reverse walk
        gv = torch.einsum("bhij,bhj->bhi", g, v[:, :, t])
        dk[:, :, t] = gv + r[:, :, t] * u * c[:, :, t, None]
        dv[:, :, t] = torch.einsum("bhij,bhi->bhj", g, k[:, :, t]) \
            + a[:, :, t, None] * dy[:, :, t]
        dlogw[:, :, t] = run - k[:, :, t] * gv
        run = dlogw[:, :, t] + rho[:, :, t]
        g = w[:, :, t, :, None] * g \
            + r[:, :, t, :, None] * dy[:, :, t, None, :]
    return dr, dk, dv, dlogw, du.sum(0), g
