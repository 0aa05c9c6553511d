"""Launch wrapper of the CUDA ``residual_norms`` kernel
(``csrc/robust_agg.cu``).

Replaces ``repro/kernels/robust_agg/kernel.py:42 residual_norms_pallas``.
The kernel is memory-bound (it reads every byte of the (C, D) buffer
once); one CUDA block owns one client row, see the source for the design.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCounter()


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("robust_agg").residual_norms_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def residual_norms_cuda(updates: torch.Tensor,
                        center: torch.Tensor) -> torch.Tensor:
    """||u_c - z||_2 over a (C, D) fp32 CUDA buffer -> (C,) fp32.

    Launches on the current stream and does not synchronise."""
    if updates.device.type != "cuda" or center.device != updates.device:
        raise ValueError(f"residual_norms cuda: updates and center must lie "
                         f"on one CUDA device, got {updates.device} and "
                         f"{center.device}")
    if updates.dtype != torch.float32 or center.dtype != torch.float32:
        raise TypeError(f"residual_norms cuda: takes float32 only, got "
                        f"{updates.dtype} / {center.dtype}")
    if updates.ndim != 2 or center.ndim != 1 \
            or center.shape[0] != updates.shape[1]:
        raise ValueError(f"residual_norms cuda: needs updates (C, D) and "
                         f"center (D,), got {tuple(updates.shape)} and "
                         f"{tuple(center.shape)}")
    if not (updates.is_contiguous() and center.is_contiguous()):
        raise ValueError("residual_norms cuda: updates and center must be "
                         "contiguous")
    C, D = updates.shape
    if C == 0 or D == 0:
        return torch.zeros((C,), dtype=torch.float32, device=updates.device)
    out = _build.empty((C,), torch.float32, updates.device)
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(updates.data_ptr(), center.data_ptr(),
                       out.data_ptr(), C, D, stream)
    if err != 0:
        raise RuntimeError(f"residual_norms cuda: launch failed with CUDA "
                           f"error {err} at C={C}, D={D}")
    launches.count += 1
    return out
