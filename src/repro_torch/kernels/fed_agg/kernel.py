"""Launch wrapper of the CUDA ``fed_agg`` kernel (``csrc/fed_agg.cu``).

Replaces ``repro/kernels/fed_agg/kernel.py:37 fed_agg_pallas``.  The
kernel is memory-bound (it reads every byte of the (C, D) buffer once);
see the source for the design.  ``block_c`` / ``block_d`` keep the
names of the TPU kernel's tile knobs: here ``block_d`` is the columns one
CUDA block owns (256 threads × 1, 2, 4 or 8 columns each) and ``block_c``
the granularity of the client chunks the grid splits C into (``geometry``:
one wave of blocks on the card, float2 loads where D is even).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

THREADS = 256
# one wave of the partial pass on an H100: one block of 256 threads on
# each of its 132 SMs.  A constant (not read from the device), so the
# chunking — and therefore the summation order — depends on the shapes
# alone
WAVE = 132

launches = _build.LaunchCounter()


class Geometry(NamedTuple):
    n_chunks: int         # grid.y: client chunks
    row_blocks: int       # ceil(C / block_c) blocks of block_c rows
    cols_per_thread: int
    col_blocks: int       # grid.x
    vec: int              # 2: float2 loads; 1: scalar loads


def geometry(C: int, D: int, block_c: int = 8, block_d: int = 2048,
             aligned: bool = True) -> Geometry:
    """Grid of one launch: (col_blocks, n_chunks) blocks of 256 threads,
    as many chunks as fill one wave (``WAVE`` blocks) with the column
    blocks, at most one a block of rows.  ``aligned``: the buffer starts
    8-byte aligned, so with an even D every row takes float2 loads.

    Raises ``ValueError`` on tile knobs the kernel has no variant for."""
    if block_d not in (THREADS, 2 * THREADS, 4 * THREADS, 8 * THREADS):
        raise ValueError(f"fed_agg cuda: block_d must be 256, 512, 1024 or "
                         f"2048 (256 threads x 1/2/4/8 columns), got "
                         f"{block_d}")
    if block_c < 1:
        raise ValueError(f"fed_agg cuda: block_c must be >= 1, got "
                         f"{block_c}")
    col_blocks = max(1, -(-D // block_d))
    row_blocks = max(1, -(-C // block_c))
    n_chunks = max(1, min(row_blocks, WAVE // col_blocks))
    vec = 2 if aligned and D % 2 == 0 and block_d >= 2 * THREADS else 1
    return Geometry(n_chunks, row_blocks, block_d // THREADS, col_blocks,
                    vec)


def chunk_rows(g: Geometry, C: int, block_c: int, i: int):
    """Rows [begin, end) of chunk ``i``, as the kernel computes them."""
    begin = block_c * (i * g.row_blocks // g.n_chunks)
    return begin, min(C, block_c * ((i + 1) * g.row_blocks // g.n_chunks))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("fed_agg").fed_agg_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fed_agg_cuda(updates: torch.Tensor, weights: torch.Tensor, *,
                 block_c: int = 8, block_d: int = 2048) -> torch.Tensor:
    """Σ_c w_c · u_c over a (C, D) fp32 CUDA buffer -> (D,) fp32.

    Launches on the current stream and does not synchronise."""
    if updates.device.type != "cuda" or weights.device != updates.device:
        raise ValueError(f"fed_agg cuda: updates and weights must lie on "
                         f"one CUDA device, got {updates.device} and "
                         f"{weights.device}")
    if updates.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"fed_agg cuda: takes float32 only, got "
                        f"{updates.dtype} / {weights.dtype}")
    if updates.ndim != 2 or weights.ndim != 1 \
            or weights.shape[0] != updates.shape[0]:
        raise ValueError(f"fed_agg cuda: needs updates (C, D) and weights "
                         f"(C,), got {tuple(updates.shape)} and "
                         f"{tuple(weights.shape)}")
    if not (updates.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fed_agg cuda: updates and weights must be "
                         "contiguous")
    C, D = updates.shape
    out = torch.empty((D,), dtype=torch.float32, device=updates.device)
    if D == 0:
        return out
    g = geometry(C, D, block_c, block_d,
                 aligned=updates.data_ptr() % 8 == 0)
    partial = out if g.n_chunks == 1 else torch.empty(
        (g.n_chunks, D), dtype=torch.float32, device=updates.device)
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(updates.data_ptr(), weights.data_ptr(),
                       out.data_ptr(), partial.data_ptr(), C, D, block_c,
                       g.row_blocks, g.n_chunks, g.cols_per_thread, g.vec,
                       stream)
    if err != 0:
        raise RuntimeError(f"fed_agg cuda: launch failed with CUDA error "
                           f"{err} at C={C}, D={D}, {g}")
    launches.count += 1
    return out
