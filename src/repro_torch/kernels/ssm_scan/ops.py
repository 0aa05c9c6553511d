"""Public wrapper: the SSD scan in the model's layout.

The port of ``repro.kernels.ssm_scan.ops``.  ``impl="cuda"`` (the
default) launches the hand-written kernel on a CUDA tensor; a tensor on
the CPU has no kernel to run and takes the plain version.  The kernel has no
backward yet: on a CUDA tensor under grad, with an input that requires
it, ``impl="cuda"`` raises ``NotImplementedError`` (ROADMAP Queue A
#15g) rather than return an output with no gradient.
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

from repro_torch.kernels.grad import refuse_grad
from repro_torch.kernels.ssm_scan.kernel import ssm_scan_cuda
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

IMPLS = ("cuda", "torch")


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
        refuse_grad("ssm_scan cuda", x, dt, A, Bm, Cm, h0)
        y, hf = ssm_scan_cuda(xk, dtk, A, Bk, Ck, h0)
    else:
        rep = x.shape[2] // Bm.shape[2]
        y, hf = ssm_scan_ref(xk, dtk, A, Bk.repeat_interleave(rep, dim=1),
                             Ck.repeat_interleave(rep, dim=1), h0)
    return y.transpose(1, 2), hf
