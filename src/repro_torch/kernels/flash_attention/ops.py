"""Public wrappers: the attention core and the model-layout adapter.

The port of ``repro.kernels.flash_attention.ops``.  ``impl="cuda"`` (the
default) launches the hand-written kernel on a CUDA tensor; a tensor on
the CPU has no kernel to run and takes the plain version.
``impl="torch"`` is the plain version on either device.  The CUDA kernel
masks the ragged ends of Sq and Sk itself, so nothing is padded here;
``block_k`` is the reference's kv tile knob and only decides, as there,
which non-causal calls are refused.

Gradients.  On a CUDA tensor under grad, fp32 and bf16 go through
``FlashAttentionFn``: the forward kernel of the dtype (both on the
tensor cores: ``flash_fwd_f32`` for fp32, every factor in three bf16
terms, and ``flash_fwd_wgmma`` for bf16), which also writes each row's
log-sum-exp, and the
hand-written backward kernels (``kernel.flash_attention_bwd_cuda``, on
the tensor cores for both: ``flash_bwd_f32`` for fp32, every factor in
three bf16 terms, and ``flash_bwd_wgmma`` for bf16, its gradients
rounded once from fp32).  ``impl="torch"`` and CPU tensors
differentiate the plain version by autograd.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda, rows_without_keys)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.grad import needs_grad

IMPLS = ("cuda", "torch")


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention on the card with a hand-written backward: the
    forward kernel (``VARIANTS``: ``flash_fwd_f32`` for fp32,
    ``flash_fwd_wgmma`` for bf16, never the SIMT one, each with the rows'
    log-sum-exp) saves q, k, v, o and lse; the
    backward kernel of the dtype (``BWD_VARIANTS``: ``flash_bwd_f32`` for
    fp32, ``flash_bwd_wgmma`` for bf16, never a SIMT one) forms dq, dk
    and dv from them in q's dtype (``csrc/flash_attention_bwd.cu``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        kw = dict(causal=causal, window=window, scale=scale,
                  q_offset=q_offset)
        out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # the incoming gradient may be any view (expanded, transposed); a
        # copy of it costs a few us against the kernel's hundreds
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse,
                                              dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    block_k: int = 128,
                    impl: str = "cuda") -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown flash_attention impl: {impl!r} "
                         f"(expected one of {IMPLS})")
    if impl == "cuda":
        Sk = k.shape[2]
        if not causal and Sk and Sk % min(block_k, Sk):
            # the reference pads keys and relies on the causal mask to
            # hide them (repro/kernels/flash_attention/ops.py:51)
            raise ValueError("non-causal flash requires Sk % block_k == 0")
        if q.device.type != "cpu":
            if not needs_grad(q, k, v):
                return flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, scale=scale,
                                            q_offset=q_offset)
            if rows_without_keys(q.shape[2], k.shape[2], q_offset, causal,
                                 window):
                raise ValueError(
                    "flash_attention cuda: under grad every query row must "
                    "see a key (the backward kernel does not take the "
                    "plain version's mean of V over every key)")
            return FlashAttentionFn.apply(q, k, v, causal, window, scale,
                                          q_offset)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset)


def flash_attention_model_layout(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, **kw) -> torch.Tensor:
    """Model layout adapter: q (B,S,Hk,G,D); k,v (B,S,Hk,D) -> (B,S,Hk,G,D).

    Query head hk·G + g attends with kv head hk.  The (B, H, S, D) views
    are strided, not copied: the kernel reads them in place and writes its
    output in q's layout, so the result is a view as well."""
    B, S, Hk, G, D = q.shape
    qc = q.reshape(B, S, Hk * G, D).transpose(1, 2)
    o = flash_attention(qc, k.transpose(1, 2), v.transpose(1, 2), **kw)
    return o.transpose(1, 2).reshape(B, S, Hk, G, D)
