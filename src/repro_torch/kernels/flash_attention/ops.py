"""Public wrappers: the attention core and the model-layout adapter.

The port of ``repro.kernels.flash_attention.ops``.  ``impl="cuda"`` (the
default) launches the hand-written kernel on a CUDA tensor; a tensor on
the CPU has no kernel to run and takes the plain version.
``impl="torch"`` is the plain version on either device.  The CUDA kernel
masks the ragged ends of Sq and Sk itself, so nothing is padded here;
``block_k`` is the reference's kv tile knob and only decides, as there,
which non-causal calls are refused.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

IMPLS = ("cuda", "torch")


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
            return flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        q_offset=q_offset)
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
