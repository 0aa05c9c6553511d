"""Plain PyTorch oracle: dense softmax attention with causal/window masking.

The port of ``repro.kernels.flash_attention.ref.attention_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
# the bf16 flash kernel's gate: bf16_excess(kernel output, fp32 truth) at
# most this.  It lies between the kernel's readings on an H100 (two bf16
# terms of P) and those of a kernel that rounds P to one bf16 term
# (PERF.md)
BF16_FLOOR = 2.0 ** -12


def _masked_scores(q, k, causal, window, scale, q_offset):
    """The scaled scores (B, Hkv, G, Sq, Sk) with masked pairs at
    ``NEG_INF``, in fp32 (float64 for float64 q)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(f) * scale, k.to(f))
    qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return torch.where(ok, s, NEG_INF)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); GQA via head grouping.

    Returns (B, Hq, Sq, D) in q's dtype (fp32 softmax inside; float64
    for float64 inputs, a truth to hold the kernels to).  Masked scores
    take the finite ``NEG_INF``, so a row that sees no key averages V
    over every key.
    """
    s = _masked_scores(q, k, causal, window, scale, q_offset)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(s.dtype))
    return o.reshape(q.shape).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      scale: Optional[float] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """Each query row's log-sum-exp of the scaled, masked scores, (B, Hq,
    Sq) in fp32 (float64 for float64 q): what the forward kernels write
    under ``with_lse`` for the backward."""
    s = _masked_scores(q, k, causal, window, scale, q_offset)
    return torch.logsumexp(s, dim=-1).reshape(q.shape[:3])


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      window: Optional[int] = None,
                      scale: Optional[float] = None, q_offset: int = 0):
    """The plain backward of :func:`attention_ref`: (dq, dk, dv) for the
    output gradient ``dout``, by autograd through it in fp32 (float64 for
    float64 inputs) on the inputs upcast, each gradient then rounded once
    to its input's dtype.  For bf16 inputs this is what the bf16 backward
    kernel computes, save the softmax's row sum delta, which the kernel
    takes from the bf16 output.  The yardstick of
    ``flash_attention_bwd_cuda`` in the tests and ``chip_smoke.py``; the
    port's model never calls it."""
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    with torch.enable_grad():
        leaves = [x.detach().to(f).requires_grad_(True) for x in (q, k, v)]
        o = attention_ref(*leaves, causal=causal, window=window,
                          scale=scale, q_offset=q_offset)
        grads = torch.autograd.grad(o, leaves, dout.to(f))
    return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of ``x`` (fp32; 0 where ``x`` is 0):
    2^(e - 7) for 2^e <= |x| < 2^(e + 1)."""
    x = x.float()
    _, e = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def bf16_excess(got: torch.Tensor, truth: torch.Tensor) -> float:
    """How far a bf16 result strays beyond one bf16 ulp of the fp32
    truth, as a share of its row's largest |truth|: the max over elements
    of (|got - truth| - ulp(truth)) / max_d |truth[..., d]|.  At most 0
    when every element lies within one ulp of the truth (a correctly
    rounded result lies within half of one); the gate of the bf16 flash
    kernel holds it to ``BF16_FLOOR``, so an error that is small against
    the row's largest output but large against an element's own ulp
    still counts."""
    truth = truth.float()
    err = (got.float() - truth).abs() - bf16_ulp(truth)
    row = truth.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return float((err / row).max())
