"""Launch wrapper of the CUDA ``flash_attention`` kernel
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py:69
flash_attention_pallas``.  The kernel takes strided (B, H, S, D) views
whose last axis is contiguous, so the model's (B, S, H, D) projections go
in without a transpose; see the source for the design and its bound.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

# the head dims of the dense configs the port serves (flude-paper 32,
# the reduced configs 64, h2o-danube-1.8b 80, qwen2-7b and llama3-405b
# 128, nemotron-4-340b 192)
HEAD_DIMS = (32, 64, 80, 128, 192)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.LaunchCounter()


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_layout(name: str, x: torch.Tensor):
    """The kernel reads rows of 4 elements at a time: the last axis
    contiguous, the other strides and the base address aligned to 4
    elements."""
    strides = x.stride()
    if strides[-1] != 1 or any(s % 4 for s in strides[:-1]) \
            or x.data_ptr() % (4 * x.element_size()):
        raise ValueError(f"flash_attention cuda: {name} must have a "
                         f"contiguous last axis and 4-element-aligned "
                         f"strides and base, got strides {strides}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) on one CUDA device ->
    (B, Hq, Sq, D) in q's dtype, laid out like q (``empty_like``).

    Launches on the current stream and does not synchronise."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention cuda: q, k and v must lie on "
                         f"one CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention cuda: takes float32 or bfloat16 "
                        f"q, k and v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention cuda: needs q (B, Hq, Sq, D) and "
                         f"k, v (B, Hkv, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention cuda: q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)} do not agree (Hq must be a "
                         f"multiple of Hkv)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention cuda: head_dim {D} has no "
                         f"kernel variant (one of {HEAD_DIMS})")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"flash_attention cuda: B ({B}) and Hq ({Hq}) "
                         f"must be at most 65535 (grid limits)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention cuda: window must be None or "
                         f">= 1, got {window}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, x)
    out = torch.empty_like(q)
    if B == 0 or Hq == 0 or Sq == 0:
        return out
    if Sk == 0:               # an empty softmax: the plain version's zeros
        return out.zero_()
    _check_layout("out", out)
    if scale is None:
        scale = D ** -0.5
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), strides, B, Hq, Hkv,
                       Sq, Sk, int(q_offset),
                       0 if window is None else int(window), int(causal),
                       float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention cuda: launch failed with CUDA "
                           f"error {err} at q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype}")
    launches.count += 1
    return out
