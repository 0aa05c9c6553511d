"""Public wrappers of the WKV6 scan: kernel layout (B, H, S, D) and the
model-layout adapter.

The port of ``repro.kernels.rwkv6_scan.ops``.  ``impl="cuda"`` (the
default) launches the hand-written kernel on a CUDA tensor; a tensor on
the CPU has no kernel to run and takes the plain version.

Gradients.  On a CUDA tensor under grad, with an input that requires it,
fp32 goes through ``WKV6ScanFn``: the forward kernel (``wkv_fwd_simt``)
and the hand-written backward kernel (``kernel.rwkv6_scan_bwd_cuda``,
``csrc/rwkv6_scan_bwd.cu``).  bf16 has no backward kernel yet and raises
``NotImplementedError`` (ROADMAP Queue A #15g step 3) rather than return
an output with no gradient.  ``impl="torch"`` and CPU tensors
differentiate the plain version by autograd.

``impl="torch"`` is the plain version (the per-step oracle
``rwkv6_scan_ref``) on either device.  The kernel's variant follows the
dtype of r, k and v (``kernel.VARIANTS``: fp32 SIMT, bf16 tensor cores).
It masks the ragged end of S itself and reads every tensor through its
strides, so nothing is padded or copied here; the reference's ``chunk``
knob is not taken (the SIMT variant stages 32 steps at a time, the
tensor-core one works in sub-chunks of 16, the oracle has none).
``wkv_kernel_adapter`` plugs into ``repro_torch.models.rwkv.time_mix``'s
``kernel=`` hook (the contract of ``wkv_recurrence``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.grad import needs_grad, refuse_grad
from repro_torch.kernels.rwkv6_scan.kernel import (rwkv6_scan_bwd_cuda,
                                                   rwkv6_scan_cuda)
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

IMPLS = ("cuda", "torch")


class WKV6ScanFn(torch.autograd.Function):
    """The fp32 WKV6 scan on the card with a hand-written backward, in the
    kernel layout: the forward kernel (``wkv_fwd_simt``) saves its
    inputs; the backward kernel (``csrc/rwkv6_scan_bwd.cu``) walks the
    recurrence forward and back from them and forms every input's
    gradient."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        y, sf = rwkv6_scan_cuda(r, k, v, logw, u, s0)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        ctx.set_materialize_grads(False)
        return y, sf

    @staticmethod
    def backward(ctx, dy, dsf):
        r, k, v, logw, u, s0 = ctx.saved_tensors
        # the incoming gradient may be any view (expanded, transposed) or
        # None (y unused); a copy costs a few us against the kernel
        dy = torch.zeros_like(r) if dy is None else \
            dy if dy.stride(-1) == 1 else dy.contiguous()
        return rwkv6_scan_bwd_cuda(r, k, v, logw, u, s0, dy, dsf)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None, *, impl: str = "cuda"):
    """Kernel layout (B, H, S, D) in and out; u (H, D); s0 (B, H, D, D)
    fp32 or None.  Returns y fp32 and the final state fp32."""
    if impl not in IMPLS:
        raise ValueError(f"unknown rwkv6_scan impl: {impl!r} (expected one "
                         f"of {IMPLS})")
    if impl == "cuda" and r.device.type != "cpu":
        if not needs_grad(r, k, v, logw, u, s0):
            return rwkv6_scan_cuda(r, k, v, logw, u, s0)
        if any(t.dtype != torch.float32 for t in (r, k, v, logw, u)):
            refuse_grad(f"rwkv6_scan cuda ({r.dtype})", r, k, v, logw, u,
                        s0)
        return WKV6ScanFn.apply(r, k, v, logw, u, s0)
    return rwkv6_scan_ref(r, k, v, logw, u, s0)


def wkv_kernel_adapter(impl: str = "cuda"):
    """Returns fn(r, k, v, logw, u, state) in model layout (B, S, H, D),
    ``state`` (B, H, D, D) fp32 or None; the (B, H, S, D) views are
    strided, not copied."""
    if impl not in IMPLS:
        raise ValueError(f"unknown rwkv6_scan impl: {impl!r} (expected one "
                         f"of {IMPLS})")

    def fn(r, k, v, logw, u, state):
        y, sf = rwkv6_scan(r.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), logw.transpose(1, 2), u,
                           state, impl=impl)
        return y.transpose(1, 2), sf
    return fn
