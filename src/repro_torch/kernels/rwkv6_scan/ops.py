"""Public wrappers of the WKV6 scan: kernel layout (B, H, S, D) and the
model-layout adapter.

The port of ``repro.kernels.rwkv6_scan.ops``.  ``impl="cuda"`` (the
default) launches the hand-written kernel on a CUDA tensor; a tensor on
the CPU has no kernel to run and takes the plain version.  The kernel has no
backward yet: on a CUDA tensor under grad, with an input that requires
it, ``impl="cuda"`` raises ``NotImplementedError`` (ROADMAP Queue A
#15g) rather than return an output with no gradient.
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

from repro_torch.kernels.grad import refuse_grad
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_cuda
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

IMPLS = ("cuda", "torch")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None, *, impl: str = "cuda"):
    """Kernel layout (B, H, S, D) in and out; u (H, D); s0 (B, H, D, D)
    fp32 or None.  Returns y fp32 and the final state fp32."""
    if impl not in IMPLS:
        raise ValueError(f"unknown rwkv6_scan impl: {impl!r} (expected one "
                         f"of {IMPLS})")
    if impl == "cuda" and r.device.type != "cpu":
        refuse_grad("rwkv6_scan cuda", r, k, v, logw, u, s0)
        return rwkv6_scan_cuda(r, k, v, logw, u, s0)
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
