"""Launch wrapper of the CUDA ``rwkv6_scan`` kernel
(``csrc/rwkv6_scan.cu``).

Replaces ``repro/kernels/rwkv6_scan/kernel.py:55 rwkv6_scan_pallas``.  Two
variants, chosen by the dtype of r, k and v with no fallback between
them: fp32 launches ``wkv_fwd_simt`` (the per-step recurrence, one block
of D threads a (batch, head), thread j holding column j of the (D, D)
fp32 state in registers: latency-bound), bf16 launches ``wkv_fwd_mma``
(the chunked form of ``wkv_chunked`` in sub-chunks of 16 steps on tensor
cores, the fp32 operands as three bf16 terms, every decay a product of
w's <= 1; a cluster of two blocks of 128 threads a (batch, head), each
owning half of the keys, that is of the state's rows, the two trading
partial y by st.async; bound by the bytes it moves, held back by the
latency of its SIMT parts).  Every tensor is read through its strides,
so the model's (B, S, H, D) layout goes in without a transpose.  See the
source for the design and its bound.

``rwkv6_scan_bwd_cuda`` launches ``wkv_bwd_simt``
(``csrc/rwkv6_scan_bwd.cu``), the gradient of the fp32 variant: the
backward of the fp32 training forward.  The JAX package has no backward
kernel (its model trains through plain JAX); ``bwd_launches`` counts
this one's calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

# rwkv6-7b's head size and its reduced() variant's
HEAD_DIMS = (32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {torch.float32: "simt", torch.bfloat16: "mma"}
SUB = 16                        # steps of a sub-chunk (mma)
STAGED = 32                     # steps staged at once (SIMT)

launches = _build.LaunchCounter(variants=("mma", "simt"))
# one count a call of rwkv6_scan_bwd_cuda, by variant: fp32 SIMT is the
# only one so far (the bf16 backward is ROADMAP Queue A #15g step 3)
bwd_launches = _build.LaunchCounter(variants=("simt",))


def smem_bytes(variant: str, D: int, w_dtype=torch.float32) -> int:
    """Shared memory of one block, as ``csrc/rwkv6_scan.cu`` sizes it.
    SIMT (static): r, k, w and v of 32 steps and u, fp32.  mma (dynamic):
    two stages of r, k and logw (the block's D / 2 keys, logw in its own
    dtype) and v (all D values); w = exp(logw) of its keys in fp32; three
    bf16 terms each of r o cp and k o cs (its keys) and of its D / 2 rows
    of the state; the other block's partial y of its columns, by
    sub-chunk parity, and its own partial scores; its decays and u; the
    midpoint factors of the scores' dense 8 x 8 block; two mbarriers."""
    if variant == "simt":
        return 4 * (4 * STAGED * D + D)
    DH = D // 2
    esize = torch.finfo(w_dtype).bits // 8
    stage = 2 * SUB * DH * 2 + SUB * D * 2 + SUB * DH * esize
    return (2 * stage + SUB * DH * 4 + 3 * (2 * SUB * DH * 2 + DH * D * 2)
            + 2 * SUB * DH * 4 + SUB * SUB * 4 + 2 * DH * 4
            + 2 * 8 * (DH + 4) * 4 + 2 * 8)


def bwd_smem_bytes(D: int) -> int:
    """Dynamic shared memory of one ``wkv_bwd_simt`` block, as
    ``csrc/rwkv6_scan_bwd.cu`` sizes it: r, k, w, v, dy and rho of 32
    steps, two values a step (v.dy and the bonus term) and u, fp32."""
    return 4 * (6 * STAGED * D + 2 * STAGED + D)


def launch_shape(variant: str, B: int, H: int, D: int):
    """(grid, threads a block) of one launch: SIMT one block of D threads
    a (batch, head), mma one cluster of two blocks of 128 (each half of
    the keys: of the state's rows)."""
    if variant == "simt":
        return (H, B), D
    return (2 * H, B), 128


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("rwkv6_scan").rwkv6_scan_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rwkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logw: torch.Tensor, u: torch.Tensor,
                    s0: Optional[torch.Tensor] = None):
    """r, k, v, logw: (B, H, S, D); u: (H, D); s0: (B, H, D, D) fp32 or
    None (zeros), all on one CUDA device.

    Returns y (B, H, S, D) fp32 — a view of (B, S, H, D) memory, the
    model's layout — and the final state (B, H, D, D) fp32.  fp32 r, k
    and v launch the SIMT variant, bf16 the mma one.  Launches on the
    current stream and does not synchronise."""
    dev = r.device
    tensors = (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u)) + \
        ((("s0", s0),) if s0 is not None else ())
    if dev.type != "cuda" or any(t.device != dev for _, t in tensors):
        raise ValueError(f"rwkv6_scan cuda: every tensor must lie on one "
                         f"CUDA device, got " + ", ".join(
                             f"{n} {t.device}" for n, t in tensors))
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype \
            or logw.dtype not in DTYPES:
        raise TypeError(f"rwkv6_scan cuda: takes float32 or bfloat16 r, k "
                        f"and v of one dtype and a float32 or bfloat16 "
                        f"logw, got {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{logw.dtype}")
    if s0 is not None and s0.dtype != torch.float32:
        raise TypeError(f"rwkv6_scan cuda: s0 must be float32, got "
                        f"{s0.dtype}")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"rwkv6_scan cuda: needs r, k, v, logw of one "
                         f"shape (B, H, S, D), got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(logw.shape)}")
    B, H, S, D = r.shape
    if tuple(u.shape) != (H, D) or \
            (s0 is not None and tuple(s0.shape) != (B, H, D, D)):
        raise ValueError(f"rwkv6_scan cuda: u {tuple(u.shape)} or s0 "
                         f"{None if s0 is None else tuple(s0.shape)} does "
                         f"not agree with r {tuple(r.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan cuda: head size {D} has no kernel "
                         f"variant (one of {HEAD_DIMS})")
    if B > 65535:
        raise ValueError(f"rwkv6_scan cuda: B ({B}) must be at most 65535 "
                         f"(grid limit)")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if t.stride(-1) != 1:
            raise ValueError(f"rwkv6_scan cuda: {name} must have a "
                             f"contiguous last axis, got strides "
                             f"{t.stride()}")
        # the mma variant copies rows of 16 bytes by cp.async
        if r.dtype == torch.bfloat16 and (
                any(st * t.element_size() % 16 for st in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"rwkv6_scan cuda: with bf16 r, k, v, {name} "
                             f"must have strides that are multiples of 16 "
                             f"bytes and a 16-byte-aligned base (its rows "
                             f"are copied 16 bytes at a time), got strides "
                             f"{t.stride()}")
    y = _build.empty((B, S, H, D), torch.float32, dev).transpose(1, 2)
    if S == 0 or B == 0 or H == 0:
        sf = torch.zeros((B, H, D, D), dtype=torch.float32, device=dev) \
            if s0 is None else s0.clone()
        return y, sf
    sf = _build.empty((B, H, D, D), torch.float32, dev)
    u32 = u.float().contiguous()
    s0c = None if s0 is None else s0.contiguous()
    strides = (ctypes.c_int64 * 15)(*r.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *logw.stride()[:3],
                                    *y.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(DTYPES[r.dtype], DTYPES[logw.dtype], D,
                       r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       logw.data_ptr(), u32.data_ptr(),
                       None if s0c is None else s0c.data_ptr(),
                       y.data_ptr(), sf.data_ptr(), strides, B, H, S,
                       stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan cuda: {VARIANTS[r.dtype]} launch "
                           f"failed with CUDA error {err} at r "
                           f"{tuple(r.shape)}, {r.dtype}")
    launches.add(VARIANTS[r.dtype])
    return y, sf


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.load("rwkv6_scan_bwd").rwkv6_scan_bwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 14 + [
        ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rwkv6_scan_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        logw: torch.Tensor, u: torch.Tensor,
                        s0: Optional[torch.Tensor], dy: torch.Tensor,
                        dsf: Optional[torch.Tensor] = None):
    """The gradient of ``rwkv6_scan_cuda`` for fp32: the forward's inputs
    (r, k, v, logw (B, H, S, D), u (H, D), s0 or None), ``dy`` (B, H, S,
    D) and ``dsf`` (B, H, D, D) or None (zeros), all float32 on one CUDA
    device -> (dr, dk, dv, dlogw, du, ds0), each shaped like its input
    (ds0 None when s0 is), the four (B, H, S, D) ones views of the
    model's (B, S, H, D) memory as y is.

    The kernel writes du per (batch, head); the batch is then summed here
    by ``torch.sum``, whose reduction order is fixed (no atomics
    anywhere), so reruns are bit-identical.  Launches one kernel on the
    current stream (plus that sum) and does not synchronise."""
    dev = r.device
    tensors = (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
               ("dy", dy)) + ((("s0", s0),) if s0 is not None else ()) + \
        ((("dsf", dsf),) if dsf is not None else ())
    if dev.type != "cuda" or any(t.device != dev for _, t in tensors):
        raise ValueError("rwkv6_scan_bwd cuda: every tensor must lie on one "
                         "CUDA device, got " + ", ".join(
                             f"{n} {t.device}" for n, t in tensors))
    if any(t.dtype != torch.float32 for _, t in tensors):
        raise TypeError("rwkv6_scan_bwd cuda: float32 only (the bf16 "
                        "backward is ROADMAP Queue A #15g step 3), got "
                        + ", ".join(f"{n} {t.dtype}" for n, t in tensors))
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, logw, dy)):
        raise ValueError(f"rwkv6_scan_bwd cuda: needs r, k, v, logw, dy of "
                         f"one shape (B, H, S, D), got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(logw.shape)}, {tuple(dy.shape)}")
    B, H, S, D = r.shape
    if tuple(u.shape) != (H, D) or any(
            t is not None and tuple(t.shape) != (B, H, D, D)
            for t in (s0, dsf)):
        raise ValueError(f"rwkv6_scan_bwd cuda: u {tuple(u.shape)}, s0 or "
                         f"dsf does not agree with r {tuple(r.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan_bwd cuda: head size {D} has no "
                         f"kernel variant (one of {HEAD_DIMS})")
    if B > 65535:
        raise ValueError(f"rwkv6_scan_bwd cuda: B ({B}) must be at most "
                         f"65535 (grid limit)")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw),
                    ("dy", dy)):
        if t.stride(-1) != 1:
            raise ValueError(f"rwkv6_scan_bwd cuda: {name} must have a "
                             f"contiguous last axis, got strides "
                             f"{t.stride()}")
    dr, dk, dv, dlogw = (_build.empty((B, S, H, D), torch.float32,
                                      dev).transpose(1, 2)
                         for _ in range(4))
    ds0 = None if s0 is None else _build.empty((B, H, D, D), torch.float32,
                                               dev)
    if S == 0 or B == 0 or H == 0:
        if ds0 is not None:
            ds0 = dsf.clone() if dsf is not None else torch.zeros_like(s0)
        return dr, dk, dv, dlogw, torch.zeros_like(u), ds0
    du = _build.empty((B, H, D), torch.float32, dev)
    u32 = u.contiguous()
    s0c = None if s0 is None else s0.contiguous()
    dsfc = None if dsf is None else dsf.contiguous()
    strides = (ctypes.c_int64 * 27)(*(s for t in (r, k, v, logw, dy, dr, dk,
                                                  dv, dlogw)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_entry()(D, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                           logw.data_ptr(), u32.data_ptr(),
                           None if s0c is None else s0c.data_ptr(),
                           dy.data_ptr(),
                           None if dsfc is None else dsfc.data_ptr(),
                           dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                           dlogw.data_ptr(), du.data_ptr(),
                           None if ds0 is None else ds0.data_ptr(),
                           strides, B, H, S, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd cuda: launch failed with CUDA "
                           f"error {err} at r {tuple(r.shape)}")
    bwd_launches.add("simt")
    return dr, dk, dv, dlogw, du.sum(0), ds0
