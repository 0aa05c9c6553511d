"""Mamba2 (SSD, state-space duality) block: full-sequence forward and the
one-token decode step.

The port of ``repro.models.ssm``, used by zamba2 (hybrid).  The
full-sequence scan runs under one of two impls:

* ``"cuda"`` (the default): on a CUDA tensor,
  ``repro_torch.kernels.ssm_scan.ops.ssm_scan``, the hand-written Hopper
  kernel (under grad in fp32 through ``SSDScanFn``, whose backward is a
  hand-written kernel too); on a CPU tensor, which has no kernel to run,
  as ``"torch"``;
* ``"torch"``: ``_ssd_chunked``, the reference model's own chunked form
  (intra-chunk masked products, the (H, P, N) state carried across chunks
  in a Python loop), at ``cfg.ssm.chunk_size``.

The decode step is plain PyTorch, as the reference's is plain JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.models import layers as L

SCAN_IMPLS = ("cuda", "torch")


class SSMState(NamedTuple):
    conv: torch.Tensor     # (B, K-1, conv_channels) rolling conv input window
    ssm: torch.Tensor      # (B, H, P, N) fp32 state
    length: torch.Tensor   # (B,)


def ssm_spec(cfg, layered: Optional[int] = None):
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    G = s.n_groups
    conv_ch = d_inner + 2 * G * s.d_state
    dt = L.cfg_dtype(cfg.param_dtype)

    def w(shape, axes, init="normal", scale=1.0):
        if layered is not None:
            shape = (layered,) + shape
            axes = ("layers",) + axes
        return L.ParamSpec(shape, init, dt, axes, scale)

    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": w((d, d_inner + conv_ch + H), ("embed", "ssm_in")),
        "conv_w": w((s.conv_kernel, conv_ch), ("conv", "ssm_conv"),
                    scale=1.0),
        "conv_b": w((conv_ch,), ("ssm_conv",), "zeros"),
        "a_log": w((H,), ("heads",), "zeros"),   # A = -exp(a_log)
        "d_skip": w((H,), ("heads",), "ones"),
        "dt_bias": w((H,), ("heads",), "zeros"),
        "norm": w((d_inner,), ("ssm_inner",), "ones"),
        "w_out": w((d_inner, d), ("ssm_inner", "embed")),
    }


def _split_proj(p, x, cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    G, N = s.n_groups, s.d_state
    H = d_inner // s.head_dim
    zxbcdt = x @ p["w_in"].to(x.dtype)
    z, xconv, dt_raw = torch.split(
        zxbcdt, [d_inner, d_inner + 2 * G * N, H], dim=-1)
    return z, xconv, dt_raw, (d_inner, G, N, H)


def _causal_conv(xconv, p, cfg):
    """Depthwise causal conv1d via K shifted adds, as the reference (not
    ``F.conv1d``, which cuDNN would run in TF32 on the card)."""
    K = cfg.ssm.conv_kernel
    w = p["conv_w"].to(xconv.dtype)
    S = xconv.shape[1]
    out = torch.zeros_like(xconv)
    for i in range(K):
        shift = K - 1 - i
        shifted = F.pad(xconv, (0, 0, shift, 0))[:, :S]
        out = out + shifted * w[i]
    return F.silu(out + p["conv_b"].to(xconv.dtype))


def _ssd_chunked(xh, dtv, A, Bm, Cm, h0=None, chunk=256):
    """Chunked SSD scan, the reference's plain form.

    xh:  (B, S, H, P)  input heads
    dtv: (B, S, H)     positive step sizes
    A:   (H,)          negative decay rates
    Bm:  (B, S, G, N)  input matrices (groups broadcast over heads)
    Cm:  (B, S, G, N)  output matrices
    h0:  optional initial state (B, H, P, N)
    Returns y (B, S, H, P) in xh's dtype and the final state (B, H, P, N)
    fp32.
    """
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        # dt = 0 on padded steps: identity decay, zero contribution
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtv = F.pad(dtv, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // chunk

    xc = xh.reshape(B, nc, chunk, H, P)
    dtc = dtv.reshape(B, nc, chunk, H).float()
    Bc = Bm.reshape(B, nc, chunk, G, N)
    Cc = Cm.reshape(B, nc, chunk, G, N)
    a = dtc * A.float()                                 # (B,nc,c,H) negative
    seg = torch.cumsum(a, dim=2)                        # within-chunk cumsum
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))

    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device) \
        if h0 is None else h0.float()
    ys = []
    for k in range(nc):
        xk, dtk, segk = xc[:, k], dtc[:, k], seg[:, k]
        # expand groups over heads
        Bh = Bc[:, k].repeat_interleave(rep, dim=2).float()   # (B,c,H,N)
        Ch = Cc[:, k].repeat_interleave(rep, dim=2).float()
        # intra-chunk: M[i,j] = (C_i . B_j) exp(seg_i - seg_j) [j <= i].
        # The exponent is masked before exp: above the diagonal seg_i -
        # seg_j > 0 and exp of a chunk's decay span past ~88 is inf, whose
        # product with the masked zero makes the gradient NaN (the
        # reference, repro/models/ssm.py:124, masks after exp and has
        # that NaN); the forward values are the same
        cb = torch.einsum("bihn,bjhn->bhij", Ch, Bh)
        dseg = segk[:, :, None, :] - segk[:, None, :, :]     # (B,i,j,H)
        dseg = dseg.permute(0, 3, 1, 2)                      # (B,H,i,j)
        M = cb * torch.exp(torch.where(mask, dseg, -torch.inf))
        xdt = xk.float() * dtk[..., None]                    # (B,c,H,P)
        y_intra = torch.einsum("bhij,bjhp->bihp", M, xdt)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bihn,bhpn,bih->bihp", Ch, h,
                               torch.exp(segk))
        # state update: h' = exp(seg_last) h + sum_j exp(seg_last - seg_j)
        #                                          dt_j x_j B_j^T
        seg_last = segk[:, -1:, :]                           # (B,1,H)
        w = torch.exp(seg_last - segk)                       # (B,c,H)
        dh = torch.einsum("bjhp,bjhn,bjh->bhpn", xdt, Bh, w)
        h = torch.exp(seg_last[:, 0, :])[:, :, None, None] * h + dh
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(B, S + pad, H, P)[:, :S]
    return y.to(xh.dtype), h


def _ssd_kernel(xh, dtv, A, Bm, Cm, h0=None):
    """The SSD scan through ``ops.ssm_scan`` (the kernel on a CUDA tensor,
    the per-step oracle on a CPU one) in ``_ssd_chunked``'s contract: y
    cast to xh's dtype, the final state fp32."""
    y, hF = ssm_scan(xh, dtv, A, Bm, Cm, h0)
    return y.to(xh.dtype), hF


def ssm_forward(p, x, cfg, state: Optional[SSMState] = None,
                return_state: bool = False, *, impl: str = "cuda"):
    """Full-sequence Mamba2 block.  x: (B, S, d).

    ``impl`` picks the scan (see the module docstring).  The kernel
    returns fp32 y; ``_ssd_kernel`` casts it to the model dtype at the
    point where the reference's ``_ssd_chunked`` casts it, before the
    ``d_skip`` term.
    With ``return_state`` the conv window is the raw (pre-activation)
    tail of the first input projection, where the reference recomputes
    the projection (``repro/models/ssm.py:170``): the same values with one
    projection fewer."""
    if impl not in SCAN_IMPLS:
        raise ValueError(f"ssm_forward impl must be one of {SCAN_IMPLS}, "
                         f"got {impl!r}")
    s = cfg.ssm
    z, xconv_raw, dt_raw, (d_inner, G, N, H) = _split_proj(p, x, cfg)
    xconv = _causal_conv(xconv_raw, p, cfg)
    xh, Bm, Cm = torch.split(xconv, [d_inner, G * N, G * N], dim=-1)
    B_, S_ = x.shape[0], x.shape[1]
    xh = xh.reshape(B_, S_, H, s.head_dim)
    Bm = Bm.reshape(B_, S_, G, N)
    Cm = Cm.reshape(B_, S_, G, N)
    dtv = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())
    h0 = state.ssm if state is not None else None
    if impl == "cuda" and x.device.type != "cpu":
        y, hF = _ssd_kernel(xh, dtv, A, Bm, Cm, h0)
    else:
        y, hF = _ssd_chunked(xh, dtv, A, Bm, Cm, h0=h0, chunk=s.chunk_size)
    y = y + xh * p["d_skip"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(B_, S_, d_inner)
    y = _gated_norm(y, z, p)
    out = y @ p["w_out"].to(x.dtype)
    if return_state:
        K = s.conv_kernel
        # a copy: a view would keep the whole projection alive in the cache
        conv_state = xconv_raw[:, -(K - 1):, :].clone()
        st = SSMState(conv_state.to(x.dtype), hF,
                      torch.full((B_,), S_, dtype=torch.int32,
                                 device=x.device))
        return out, st
    return out


def _gated_norm(y, z, p, eps=1e-5):
    yf = y.float() * F.silu(z.float())
    yf = yf * torch.rsqrt((yf ** 2).mean(-1, keepdim=True) + eps)
    return (yf * p["norm"].float()).to(y.dtype)


def ssm_decode_step(p, x, cfg, state: SSMState):
    """One-token decode.  x: (B, 1, d)."""
    s = cfg.ssm
    z, xconv_new, dt_raw, (d_inner, G, N, H) = _split_proj(p, x, cfg)
    K = s.conv_kernel
    # conv over the rolling window [state.conv, xconv_new]
    win = torch.cat([state.conv, xconv_new], dim=1)          # (B, K, C)
    w = p["conv_w"].to(win.dtype)
    conv_out = torch.einsum("bkc,kc->bc", win[:, -K:], w) \
        + p["conv_b"].to(win.dtype)
    conv_out = F.silu(conv_out)[:, None, :]                   # (B,1,C)
    xh, Bm, Cm = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)
    B_ = x.shape[0]
    xh = xh.reshape(B_, H, s.head_dim)
    rep = H // G
    Bh = Bm.reshape(B_, G, N).repeat_interleave(rep, dim=1)
    Ch = Cm.reshape(B_, G, N).repeat_interleave(rep, dim=1)
    dtv = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())  # (B,H)
    A = -torch.exp(p["a_log"].float())
    da = torch.exp(dtv * A)                                    # (B,H)
    xdt = xh.float() * dtv[..., None]                          # (B,H,P)
    h_new = (da[..., None, None] * state.ssm
             + torch.einsum("bhp,bhn->bhpn", xdt, Bh.float()))
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ch.float())
    y = y.to(x.dtype) + xh * p["d_skip"].to(xh.dtype)[None, :, None]
    y = y.reshape(B_, 1, d_inner)
    y = _gated_norm(y, z, p)
    out = y @ p["w_out"].to(x.dtype)
    new_conv = win[:, 1:]
    return out, SSMState(new_conv, h_new, state.length + 1)


def init_ssm_state(cfg, batch: int, *, device="cuda"):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    dt = L.cfg_dtype(cfg.param_dtype)
    return SSMState(
        torch.zeros((batch, s.conv_kernel - 1, conv_ch), dtype=dt,
                    device=device),
        torch.zeros((batch, H, s.head_dim, s.d_state), dtype=torch.float32,
                    device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))
