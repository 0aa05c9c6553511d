"""Public wrapper: the SSD scan in the model's layout.

The port of ``repro.kernels.ssm_scan.ops``.  ``impl="cuda"`` (the
default) launches the hand-written kernel on a CUDA tensor; a tensor on
the CPU has no kernel to run and takes the plain version.

Gradients.  On a CUDA tensor under grad, with an input that requires it,
fp32 and bf16 go through ``SSDScanFn``: the forward kernel of the dtype
(``ssd_fwd_simt`` for fp32, ``ssd_fwd_mma`` for bf16) and the
hand-written backward kernel of the dtype (``kernel.ssm_scan_bwd_cuda``,
both on the tensor cores: ``ssd_bwd_mma_f32`` for fp32, every factor of
its chunk products in bf16 terms, variant ``mma_f32``; ``ssd_bwd_mma``
for bf16, variant ``mma_bf16``; each gradient rounded once to its
input's dtype; ``ssd_bwd_simt``'s SIMT walks only where asked for by
name).  ``impl="torch"`` and CPU tensors differentiate the plain version
by autograd.

``impl="torch"`` is the plain version (the per-step oracle
``ssm_scan_ref``) on either device.  The kernel's variant follows the
dtype of x, B and C (``kernel.VARIANTS``: fp32 SIMT, bf16 tensor cores).
It reads B and C per group and every tensor through its strides, so
nothing is copied or padded here; the reference's ``chunk`` knob is not
taken, as both variants' chunk is fixed (64 rows) and the per-step
oracle has none.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.grad import needs_grad
from repro_torch.kernels.ssm_scan.kernel import (rows_error,
                                                 ssm_scan_bwd_cuda,
                                                 ssm_scan_cuda)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

IMPLS = ("cuda", "torch")


class SSDScanFn(torch.autograd.Function):
    """The SSD scan on the card with a hand-written backward, in the
    kernel layout: the forward kernel (``ssd_fwd_simt`` for fp32 x, B and
    C, ``ssd_fwd_mma`` for bf16) saves its inputs; the backward kernel
    (``ssd_bwd_mma_f32`` for fp32, ``ssd_bwd_mma`` for bf16, both on the
    tensor cores) rebuilds the chunk-start states from them in fp32 and
    forms every input's gradient in that input's dtype."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0):
        y, hf = ssm_scan_cuda(x, dt, A, Bm, Cm, h0)
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0)
        ctx.set_materialize_grads(False)
        return y, hf

    @staticmethod
    def backward(ctx, dy, dhf):
        x, dt, A, Bm, Cm, h0 = ctx.saved_tensors
        # the incoming gradient may be any view (expanded, transposed) or
        # None (y unused, fp32 zeros); the kernels read its rows 16 bytes
        # at a time, so any other layout is copied (a few us against the
        # kernel)
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        elif rows_error(dy) is not None:
            dy = dy.contiguous()
        # so are fp32 x, B and C, which the SIMT forward takes in any
        # layout with a contiguous last axis
        x, Bm, Cm = (t if rows_error(t) is None else t.contiguous()
                     for t in (x, Bm, Cm))
        return ssm_scan_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, dhf)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *, impl: str = "cuda"):
    """Model layout: x (B, S, H, P); dt (B, S, H); A (H,); Bm, Cm
    (B, S, G, N); h0 (B, H, P, N) fp32 or None.

    Returns y (B, S, H, P) fp32 and the final state (B, H, P, N) fp32."""
    if impl not in IMPLS:
        raise ValueError(f"unknown ssm_scan impl: {impl!r} (expected one "
                         f"of {IMPLS})")
    xk, dtk = x.transpose(1, 2), dt.transpose(1, 2)
    Bk, Ck = Bm.transpose(1, 2), Cm.transpose(1, 2)
    if impl == "cuda" and x.device.type != "cpu":
        if not needs_grad(x, dt, A, Bm, Cm, h0):
            y, hf = ssm_scan_cuda(xk, dtk, A, Bk, Ck, h0)
        else:
            y, hf = SSDScanFn.apply(xk, dtk, A, Bk, Ck, h0)
    else:
        rep = x.shape[2] // Bm.shape[2]
        y, hf = ssm_scan_ref(xk, dtk, A, Bk.repeat_interleave(rep, dim=1),
                             Ck.repeat_interleave(rep, dim=1), h0)
    return y.transpose(1, 2), hf
