"""Launch wrapper of the CUDA ``ssm_scan`` kernel (``csrc/ssm_scan.cu``).

Replaces ``repro/kernels/ssm_scan/kernel.py:66 ssm_scan_pallas``.  Two
variants, chosen by the dtype of x, B and C with no fallback between them:
fp32 launches ``ssd_fwd_simt`` (one block of 256 threads a (batch, head),
the three chunk products as fp32 FMAs, bound by the SIMT rate), bf16
launches ``ssd_fwd_mma`` (two blocks of 128 threads a (batch, head), each
owning half of P; the chunk products on tensor cores with the fp32
factors as two bf16 terms, the next chunk staged by cp.async while this
one computes: bound by the bytes it moves).  Both walk the chunks of S
with the (P, N) fp32 state on the SM, read B and C per group (no
``repeat`` copy) and every tensor through its strides, so the model's
(B, S, H, P) layout goes in without a transpose.  See the source for the
design and its bound.

``ssm_scan_bwd_cuda`` launches ``ssd_bwd_simt`` (``csrc/ssm_scan_bwd.cu``),
the gradient of either variant: the backward of the training forward,
fp32 or bf16 (fp32 SIMT walks on bf16 values widened as they load, each
gradient rounded once to its input's dtype).  The JAX package has no
backward kernel (its model trains through plain JAX); ``bwd_launches``
counts this one's calls by the dtype of x, B and C.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

# (P, N): zamba2-1.2b's SSD heads (64, 64), its reduced() variant's
# (32, 16), and the two mixed sizes
SIZES = ((32, 16), (32, 64), (64, 16), (64, 64))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {torch.float32: "simt", torch.bfloat16: "mma"}
CHUNK = 64                      # rows of a chunk inside the kernel

launches = _build.LaunchCounter(variants=("mma", "simt"))
# one count a call of ssm_scan_bwd_cuda, by variant: SIMT on fp32 x, B
# and C, SIMT on bf16 ones
BWD_VARIANTS = {torch.float32: "simt", torch.bfloat16: "simt_bf16"}
bwd_launches = _build.LaunchCounter(variants=tuple(BWD_VARIANTS.values()))


def smem_bytes(variant: str, P: int, N: int) -> int:
    """Dynamic shared memory of one block, as ``csrc/ssm_scan.cu`` sizes
    it.  SIMT: x·dt, B, C, the state and the masked decay matrix in fp32,
    rows padded by one float, and four rows of 64 (dt, seg, exp(seg),
    exp(seg_last - seg)).  mma: two stages of x (P / 2 columns), B and C
    in bf16 and dt in fp32, the state's two bf16 terms and each of the 4
    warps' seg."""
    L = CHUNK
    if variant == "simt":
        return 4 * (L * (P + 1) + 2 * L * (N + 1) + P * (N + 1)
                    + L * (L + 1) + 4 * L)
    PB = P // 2
    stage = L * PB * 2 + 2 * L * N * 2 + L * 4
    return 2 * stage + 2 * PB * N * 2 + 4 * L * 4


def bwd_smem_bytes(P: int, N: int) -> int:
    """Dynamic shared memory of one ``ssd_bwd_simt`` block, as
    ``csrc/ssm_scan_bwd.cu`` sizes it: x and dy, B and C, Gc and the
    chunk's start state, M and Q, rows padded by one float, six rows of
    64 (dt, seg, exp(seg), exp(seg_last - seg), q, r) and eight
    partials, fp32."""
    L = CHUNK
    return 4 * (2 * L * (P + 1) + 2 * L * (N + 1) + 2 * P * (N + 1)
                + 2 * L * (L + 1) + 6 * L + 8)


def launch_shape(variant: str, B: int, H: int):
    """(grid, threads a block) of one launch: SIMT one block a (batch,
    head), mma two (each half of P)."""
    if variant == "simt":
        return (H, B), 256
    return (2 * H, B), 128


def _check_rows(name: str, t: torch.Tensor):
    """The mma variant copies rows of 16 bytes by cp.async: every stride
    but the last a multiple of 8 bf16 elements, and a 16-byte-aligned
    base."""
    if any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"ssm_scan cuda: bf16 {name} must have strides "
                         f"that are multiples of 8 elements and a 16-byte-"
                         f"aligned base (its rows are copied 16 bytes at a "
                         f"time), got strides {t.stride()}")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("ssm_scan").ssm_scan_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor,
                  h0: Optional[torch.Tensor] = None):
    """x: (B, H, S, P); dt: (B, H, S); A: (H,); Bm, Cm: (B, G, S, N) with
    head h reading group h // (H // G) (G == H: groups already expanded);
    h0: (B, H, P, N) fp32 or None (zeros), all on one CUDA device.

    Returns y (B, H, S, P) fp32 — a view of (B, S, H, P) memory, the
    model's layout — and the final state (B, H, P, N) fp32.  fp32 x, B
    and C launch the SIMT variant, bf16 the mma one.  Launches on the
    current stream and does not synchronise."""
    dev = x.device
    tensors = (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)) + \
        ((("h0", h0),) if h0 is not None else ())
    if dev.type != "cuda" or any(t.device != dev for _, t in tensors):
        raise ValueError(f"ssm_scan cuda: every tensor must lie on one CUDA "
                         f"device, got " + ", ".join(
                             f"{n} {t.device}" for n, t in tensors))
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype \
            or dt.dtype not in DTYPES:
        raise TypeError(f"ssm_scan cuda: takes float32 or bfloat16 x, Bm "
                        f"and Cm of one dtype and a float32 or bfloat16 "
                        f"dt, got {x.dtype}, {Bm.dtype}, {Cm.dtype}, "
                        f"{dt.dtype}")
    if h0 is not None and h0.dtype != torch.float32:
        raise TypeError(f"ssm_scan cuda: h0 must be float32, got "
                        f"{h0.dtype}")
    if x.ndim != 4 or Bm.ndim != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"ssm_scan cuda: needs x (B, H, S, P) and Bm, Cm "
                         f"(B, G, S, N), got {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    if tuple(dt.shape) != (B, H, S) or tuple(A.shape) != (H,) \
            or Bm.shape[0] != B or Bm.shape[2] != S or G == 0 or H % G \
            or (h0 is not None and tuple(h0.shape) != (B, H, P, N)):
        raise ValueError(f"ssm_scan cuda: shapes do not agree: x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)} (H "
                         f"must be a multiple of G)")
    if (P, N) not in SIZES:
        raise ValueError(f"ssm_scan cuda: (head_dim P, d_state N) = "
                         f"{(P, N)} has no kernel variant (one of {SIZES})")
    if B > 65535:
        raise ValueError(f"ssm_scan cuda: B ({B}) must be at most 65535 "
                         f"(grid limit)")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssm_scan cuda: {name} must have a contiguous "
                             f"last axis, got strides {t.stride()}")
        if x.dtype == torch.bfloat16:
            _check_rows(name, t)
    y = torch.empty((B, S, H, P), dtype=torch.float32,
                    device=dev).transpose(1, 2)
    if S == 0 or B == 0 or H == 0:
        hf = torch.zeros((B, H, P, N), dtype=torch.float32, device=dev) \
            if h0 is None else h0.clone()
        return y, hf
    hf = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    A32 = A.float().contiguous()
    h0c = None if h0 is None else h0.contiguous()
    strides = (ctypes.c_int64 * 15)(*x.stride()[:3], *dt.stride(),
                                    *Bm.stride()[:3], *Cm.stride()[:3],
                                    *y.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(DTYPES[x.dtype], DTYPES[dt.dtype], P, N,
                       x.data_ptr(), dt.data_ptr(), A32.data_ptr(),
                       Bm.data_ptr(), Cm.data_ptr(),
                       None if h0c is None else h0c.data_ptr(),
                       y.data_ptr(), hf.data_ptr(), strides, B, H, G, S,
                       stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan cuda: {VARIANTS[x.dtype]} launch "
                           f"failed with CUDA error {err} at x "
                           f"{tuple(x.shape)}, Bm {tuple(Bm.shape)}, "
                           f"{x.dtype}")
    launches.add(VARIANTS[x.dtype])
    return y, hf


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.load("ssm_scan_bwd").ssm_scan_bwd
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 15 + [
        ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssm_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor,
                      h0: Optional[torch.Tensor], dy: torch.Tensor,
                      dhf: Optional[torch.Tensor] = None):
    """The gradient of ``ssm_scan_cuda``: the forward's inputs (x (B, H,
    S, P), dt (B, H, S), A (H,), Bm, Cm (B, G, S, N), h0 or None),
    ``dy`` (B, H, S, P) and ``dhf`` (B, H, P, N) or None (zeros), on one
    CUDA device -> (dx, ddt, dA, dB, dC, dh0), each shaped like its input
    and in its dtype (dh0 None when h0 is), dx, ddt, dB and dC views of
    the model's (B, S, ·) memory as y is.  x, Bm and Cm are fp32 or bf16
    (one dtype), dt fp32 or bf16, as ``ssm_scan_cuda`` takes them; A, h0,
    dy and dhf fp32.

    The kernel computes in fp32 and writes dx and ddt in their inputs'
    dtypes, dB and dC per head and dA per (batch, head) in fp32; the heads
    of a group and the batch are then summed here in fp32 by
    ``torch.sum``, whose reduction order is fixed (no atomics anywhere),
    so reruns are bit-identical, and dB and dC rounded once to Bm's dtype
    after the sum (``sum_partials``).  Launches one kernel on the current
    stream (plus those sums) and does not synchronise."""
    dev = x.device
    tensors = (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
               ("dy", dy)) + ((("h0", h0),) if h0 is not None else ()) + \
        ((("dhf", dhf),) if dhf is not None else ())
    if dev.type != "cuda" or any(t.device != dev for _, t in tensors):
        raise ValueError("ssm_scan_bwd cuda: every tensor must lie on one "
                         "CUDA device, got " + ", ".join(
                             f"{n} {t.device}" for n, t in tensors))
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype \
            or dt.dtype not in DTYPES or any(
                t.dtype != torch.float32 for n, t in tensors
                if n in ("A", "dy", "h0", "dhf")):
        raise TypeError("ssm_scan_bwd cuda: takes float32 or bfloat16 x, Bm "
                        "and Cm of one dtype, a float32 or bfloat16 dt and "
                        "float32 A, dy, h0 and dhf, got " + ", ".join(
                            f"{n} {t.dtype}" for n, t in tensors))
    if x.ndim != 4 or Bm.ndim != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"ssm_scan_bwd cuda: needs x (B, H, S, P) and Bm, "
                         f"Cm (B, G, S, N), got {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    if tuple(dt.shape) != (B, H, S) or tuple(A.shape) != (H,) \
            or dy.shape != x.shape or Bm.shape[0] != B or Bm.shape[2] != S \
            or G == 0 or H % G \
            or any(t is not None and tuple(t.shape) != (B, H, P, N)
                   for t in (h0, dhf)):
        raise ValueError(f"ssm_scan_bwd cuda: shapes do not agree: x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, dy "
                         f"{tuple(dy.shape)} (H must be a multiple of G)")
    if (P, N) not in SIZES:
        raise ValueError(f"ssm_scan_bwd cuda: (head_dim P, d_state N) = "
                         f"{(P, N)} has no kernel variant (one of {SIZES})")
    if B > 65535:
        raise ValueError(f"ssm_scan_bwd cuda: B ({B}) must be at most "
                         f"65535 (grid limit)")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm), ("dy", dy)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssm_scan_bwd cuda: {name} must have a "
                             f"contiguous last axis, got strides "
                             f"{t.stride()}")
    dx = torch.empty((B, S, H, P), dtype=x.dtype,
                     device=dev).transpose(1, 2)
    ddt = torch.empty((B, S, H), dtype=dt.dtype,
                      device=dev).transpose(1, 2)
    dBh, dCh = (torch.empty((B, S, H, N), dtype=torch.float32,
                            device=dev).transpose(1, 2) for _ in range(2))
    dA = torch.empty((B, H), dtype=torch.float32, device=dev)
    dh0 = None if h0 is None else torch.empty((B, H, P, N),
                                              dtype=torch.float32,
                                              device=dev)
    if S == 0 or B == 0 or H == 0:
        zero = Bm.new_zeros(Bm.shape)
        if dh0 is not None:
            dh0 = dhf.clone() if dhf is not None else torch.zeros_like(h0)
        return dx, ddt, A.new_zeros(A.shape), zero, zero.clone(), dh0
    ws = torch.empty((B, H, -(-S // CHUNK), P, N), dtype=torch.float32,
                     device=dev)
    h0c = None if h0 is None else h0.contiguous()
    dhfc = None if dhf is None else dhf.contiguous()
    A32 = A.contiguous()
    strides = (ctypes.c_int64 * 27)(*(s for t in (x, dt, Bm, Cm, dy, dx,
                                                  ddt, dBh, dCh)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_entry()(DTYPES[x.dtype], DTYPES[dt.dtype], P, N,
                           x.data_ptr(), dt.data_ptr(),
                           A32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                           None if h0c is None else h0c.data_ptr(),
                           dy.data_ptr(),
                           None if dhfc is None else dhfc.data_ptr(),
                           dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                           dBh.data_ptr(), dCh.data_ptr(),
                           None if dh0 is None else dh0.data_ptr(),
                           ws.data_ptr(), strides, B, H, G, S, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd cuda: launch failed with CUDA "
                           f"error {err} at x {tuple(x.shape)}, Bm "
                           f"{tuple(Bm.shape)}, {x.dtype}")
    bwd_launches.add(BWD_VARIANTS[x.dtype])
    dB, dC = (sum_partials(t, G, Bm.dtype) for t in (dBh, dCh))
    return dx, ddt, dA.sum(0), dB, dC, dh0


def sum_partials(per_head: torch.Tensor, G: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """The per-head fp32 gradient (B, H, S, N) of a group-shared input (a
    view of (B, S, H, N) memory) summed over each group's H / G heads in
    fp32 by ``torch.sum`` (a fixed order), then rounded once to ``dtype``
    -> (B, G, S, N), a view of (B, S, G, N) memory."""
    B, H, S, N = per_head.shape
    rep = H // G
    total = per_head if rep == 1 else per_head.transpose(1, 2).reshape(
        B, S, G, rep, N).sum(3).transpose(1, 2)
    return total.to(dtype)
