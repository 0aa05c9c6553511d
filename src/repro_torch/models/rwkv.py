"""RWKV6 (Finch) block: time-mix with data-dependent decay + channel-mix.

The port of ``repro.models.rwkv``.  Attention-free: a per-head (D, D)
state evolved by a per-channel decay ``w_t = exp(-exp(w_raw_t))`` that
depends on the input.  ``time_mix`` runs the WKV recurrence through its
``kernel=`` hook when one is given (the model passes
``repro_torch.kernels.rwkv6_scan.ops.wkv_kernel_adapter()``, the
hand-written Hopper kernel, on a prefill or forward of a CUDA tensor
under ``attn_impl="cuda"``; under grad in fp32 through ``WKV6ScanFn``,
whose backward is a hand-written kernel too), and otherwise the
reference's own plain forms: ``wkv_chunked`` for S > 64, the exact
per-step ``wkv_recurrence`` for shorter inputs (a decode step among
them).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


class RWKVState(NamedTuple):
    shift_tmix: torch.Tensor   # (B, d) previous token input to time-mix
    shift_cmix: torch.Tensor   # (B, d) previous token input to channel-mix
    wkv: torch.Tensor          # (B, H, D, D) fp32 state
    length: torch.Tensor       # (B,)


def rwkv_spec(cfg, layered: Optional[int] = None):
    r = cfg.rwkv
    d = cfg.d_model
    dt = L.cfg_dtype(cfg.param_dtype)

    def w(shape, axes, init="normal", scale=1.0):
        if layered is not None:
            shape = (layered,) + shape
            axes = ("layers",) + axes
        return L.ParamSpec(shape, init, dt, axes, scale)

    return {
        # time-mix
        "mu_x": w((d,), ("embed",), "zeros"),
        "mu": w((5, d), ("mix5", "embed"), "zeros"),
        "lora_a": w((d, 5 * r.decay_lora_rank), ("embed", "lora")),
        "lora_b": w((5, r.decay_lora_rank, d), ("mix5", "lora", "embed"),
                    "zeros"),
        "w_r": w((d, d), ("embed", "heads_x_dim")),
        "w_k": w((d, d), ("embed", "heads_x_dim")),
        "w_v": w((d, d), ("embed", "heads_x_dim")),
        "w_g": w((d, d), ("embed", "heads_x_dim")),
        "w0": w((d,), ("heads_x_dim",), "zeros"),
        "w_lora_a": w((d, r.decay_lora_rank), ("embed", "lora")),
        "w_lora_b": w((r.decay_lora_rank, d), ("lora", "heads_x_dim"),
                      "zeros"),
        "u_bonus": w((d,), ("heads_x_dim",), "zeros"),
        "ln_x": w((d,), ("heads_x_dim",), "ones"),
        "w_o": w((d, d), ("heads_x_dim", "embed")),
        # channel-mix
        "cm_mu_k": w((d,), ("embed",), "zeros"),
        "cm_mu_r": w((d,), ("embed",), "zeros"),
        "cm_wk": w((d, cfg.d_ff), ("embed", "mlp")),
        "cm_wv": w((cfg.d_ff, d), ("mlp", "embed")),
        "cm_wr": w((d, d), ("embed", "embed_out")),
    }


def _token_shift(x, prev):
    """shifted[t] = x[t-1]; shifted[0] = prev (or 0)."""
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if prev is not None:
        shifted = torch.cat([prev.to(x.dtype)[:, None], shifted[:, 1:]], 1)
    return shifted


def _ddlerp(p, x, xx):
    """RWKV6 data-dependent token-shift interpolation -> 5 mixed inputs."""
    base = x + xx * p["mu_x"].to(x.dtype)
    lora = torch.tanh(base @ p["lora_a"].to(x.dtype))
    B, S, _ = x.shape
    rank = p["lora_b"].shape[1]
    lora = lora.reshape(B, S, 5, rank)
    delta = torch.einsum("bsmr,mrd->bsmd", lora, p["lora_b"].to(x.dtype))
    mix = p["mu"].to(x.dtype)[None, None] + delta          # (B,S,5,d)
    return x[:, :, None, :] + xx[:, :, None, :] * mix      # (B,S,5,d)


def wkv_recurrence(r, k, v, logw, u, state):
    """Exact WKV6 recurrence.

    r, k, v: (B, S, H, D); logw: (B, S, H, D) (log of decay, <= 0);
    u: (H, D) bonus; state: (B, H, D, D) fp32.
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1}
                                                      + k_t v_t^T
    Returns y (B, S, H, D) fp32 and the final state.
    """
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float())
    S = state
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]   # (B,H,D)
        a = torch.einsum("bhi,bhj->bhij", kt, vt)                  # k ⊗ v
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               S + u[None, :, :, None] * a))
        S = wt[..., None] * S + a
    return torch.stack(ys, 1), S


def wkv_chunked(r, k, v, logw, u, state, chunk: int = 64):
    """Chunked WKV6, the reference's plain form for long inputs.

    Per chunk of length c, with S₀ the carried state and within-chunk
    cumulative log-decays cums_t = Σ_{s≤t} logw_s (all ≤ 0):

      y_t = r_t·diag(e^{cums_{t-1}})·S₀                       (inter)
            + Σ_{j<t} (r_t ⊙ e^{cums_{t-1}-cums_j})·k_j v_jᵀ  (intra)
            + (r_t ⊙ u)·k_t v_tᵀ                              (bonus)
      S' = diag(e^{cums_last})·S₀ + Σ_j diag(e^{cums_last-cums_j}) k_j v_jᵀ

    Every exponent is ≤ 0, so nothing overflows, unlike the matmul
    factorization e^{cums_{t-1}}·e^{-cums_j}.  The (c, c, D) decay tensor
    is the price.
    """
    B, S, H, D = r.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        widths = (0, 0, 0, 0, 0, pad)
        r = F.pad(r, widths)
        k = F.pad(k, widths)          # k = 0 ⇒ no contribution
        v = F.pad(v, widths)
        logw = F.pad(logw, widths)    # logw = 0 ⇒ identity decay
    nc = (S + pad) // c

    def resh(t):
        return t.float().reshape(B, nc, c, H, D)

    rs, ks, vs, lws = resh(r), resh(k), resh(v), resh(logw)
    uf = u.float()
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      -1)                                  # strict lower
    S0 = state.float()
    ys = []
    for n in range(nc):
        rc, kc, vc, lwc = rs[:, n], ks[:, n], vs[:, n], lws[:, n]
        cums = torch.cumsum(lwc, dim=1)                    # (B, c, H, D)
        # inter-chunk: decay up to t-1 = cums shifted right by one
        cums_prev = F.pad(cums, (0, 0, 0, 0, 1, 0))[:, :-1]
        y_inter = torch.einsum("bthi,bhij->bthj", rc * torch.exp(cums_prev),
                               S0)
        # intra-chunk: A[t,j,i] = r_t k_j e^{cums_{t-1}-cums_j}, j < t,
        # the exponent formed as one difference (≤ 0 where valid)
        diff = cums_prev[:, :, None] - cums[:, None]       # (B,t,j,H,D)
        dd = torch.exp(torch.where(mask[None, :, :, None, None], diff,
                                   -1e30))
        A = torch.einsum("bthi,bjhi,btjhi->bthj", rc, kc, dd)
        y_intra = torch.einsum("bthj,bjhd->bthd", A, vc)
        # bonus diagonal: (r_t ⊙ u)·k_t scales v_t
        y_bonus = (rc * uf[None, None] * kc).sum(-1, keepdim=True) * vc
        # state update
        last = cums[:, -1:]                                # (B,1,H,D)
        wsuf = torch.exp(last - cums)                      # decay after j
        dS = torch.einsum("bjhi,bjhd->bhid", kc * wsuf, vc)
        S0 = torch.exp(last[:, 0])[..., None] * S0 + dS
        ys.append(y_inter + y_intra + y_bonus)
    y = torch.stack(ys, 1).reshape(B, S + pad, H, D)[:, :S]
    return y, S0


def time_mix(p, x, cfg, state: Optional[RWKVState], *, kernel=None):
    """The time-mix half of the block.  ``kernel`` (the contract of
    ``wkv_recurrence``, taking a state of None as zeros) runs the WKV
    scan when given; otherwise the plain forms run, by the reference's
    rule (``wkv_chunked`` for S > 64, ``wkv_recurrence`` below)."""
    r_cfg = cfg.rwkv
    d = cfg.d_model
    H, D = d // r_cfg.head_dim, r_cfg.head_dim
    B, S, _ = x.shape
    prev = state.shift_tmix if state is not None else None
    xx = _token_shift(x, prev) - x
    mixed = _ddlerp(p, x, xx)                               # (B,S,5,d)
    xr, xk, xv, xg, xw = mixed.unbind(2)
    r = (xr @ p["w_r"].to(x.dtype)).reshape(B, S, H, D)
    k = (xk @ p["w_k"].to(x.dtype)).reshape(B, S, H, D)
    v = (xv @ p["w_v"].to(x.dtype)).reshape(B, S, H, D)
    g = F.silu(xg @ p["w_g"].to(x.dtype))
    w_raw = (p["w0"].float()
             + (torch.tanh(xw @ p["w_lora_a"].to(x.dtype))
                @ p["w_lora_b"].to(x.dtype)).float())
    logw = -torch.exp(w_raw).reshape(B, S, H, D)            # log decay <= 0
    u = p["u_bonus"].float().reshape(H, D)
    s0 = state.wkv if state is not None else None
    if kernel is not None:
        y, sF = kernel(r, k, v, logw, u, s0)
    else:
        if s0 is None:
            s0 = torch.zeros((B, H, D, D), dtype=torch.float32,
                             device=x.device)
        if S > 64:
            y, sF = wkv_chunked(r, k, v, logw, u, s0, chunk=64)
        else:
            y, sF = wkv_recurrence(r, k, v, logw, u, s0)
    # per-head group norm, in fp32
    y = y.reshape(B, S, H, D)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(B, S, d)
    y = (y * p["ln_x"].float()).to(x.dtype) * g
    out = y @ p["w_o"].to(x.dtype)
    return out, sF


def channel_mix(p, x, state: Optional[RWKVState]):
    prev = state.shift_cmix if state is not None else None
    xx = _token_shift(x, prev) - x
    xk = x + xx * p["cm_mu_k"].to(x.dtype)
    xr = x + xx * p["cm_mu_r"].to(x.dtype)
    k = torch.square(F.relu(xk @ p["cm_wk"].to(x.dtype)))
    kv = k @ p["cm_wv"].to(x.dtype)
    return torch.sigmoid(xr @ p["cm_wr"].to(x.dtype)) * kv


def rwkv_block(p, x, cfg, norm1, norm2, state: Optional[RWKVState] = None,
               return_state: bool = False, kernel=None):
    """Full RWKV6 block (time-mix + channel-mix, pre-norm residual)."""
    h = L.apply_norm(norm1, x, cfg)
    tm, sF = time_mix(p, h, cfg, state, kernel=kernel)
    x = x + tm
    h2 = L.apply_norm(norm2, x, cfg)
    x = x + channel_mix(p, h2, state)
    if return_state:
        length = (state.length + x.shape[1]) if state is not None else \
            torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                       device=x.device)
        # copies: views would keep the whole normed inputs alive
        return x, RWKVState(h[:, -1, :].clone(), h2[:, -1, :].clone(), sF,
                            length)
    return x


def init_rwkv_state(cfg, batch: int, *, device="cuda"):
    d = cfg.d_model
    H, D = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    dt = L.cfg_dtype(cfg.param_dtype)
    return RWKVState(
        torch.zeros((batch, d), dtype=dt, device=device),
        torch.zeros((batch, d), dtype=dt, device=device),
        torch.zeros((batch, H, D, D), dtype=torch.float32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))
