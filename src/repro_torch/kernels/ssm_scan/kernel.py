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

``ssm_scan_bwd_cuda`` launches the gradient of either variant, the
backward of the training forward, on the tensor cores for both dtypes
(``csrc/ssm_scan_bwd_mma.cu``): fp32 runs ``ssd_bwd_mma_f32`` (variant
``mma_f32``: every factor of the chunk products as bf16 terms, three for
x, B, C and the fp32 factors, two for the chunk-start state and the
forward walk's B o w o dt, the products of a chunk into zeroed partials,
the within-chunk cumsum of dt A kept as a compensated pair, one head a
block); bf16 runs ``ssd_bwd_mma`` (variant ``mma_bf16``: the fp32
factors as two bf16 terms, a block walking ``heads_per_block`` heads of
a group and summing their dB and dC on the chip).  ``ssd_bwd_simt``
(``csrc/ssm_scan_bwd.cu``, fp32 SIMT walks) runs only where asked for
by name, on fp32 values (``variant="simt"``) or on bf16 ones widened as
they load (``"simt_bf16"``): the yardstick of the tests and
``chip_smoke.py``.
Each gradient is rounded once to its input's dtype.  The JAX package has
no backward kernel (its model trains through plain JAX);
``bwd_launches`` counts this one's calls by the variant they took.
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
# one count a call of ssm_scan_bwd_cuda, by variant: the tensor cores on
# fp32 x, B and C (the default) and on bf16 ones (the default), the SIMT
# kernel on either where asked for by name
BWD_VARIANTS = {torch.float32: "mma_f32", torch.bfloat16: "mma_bf16"}
MMA_BWD = ("mma_bf16", "mma_f32")        # the tensor-core backwards
BWD_ALLOWED = {torch.float32: ("mma_f32", "simt"),
               torch.bfloat16: ("mma_bf16", "simt_bf16")}
bwd_launches = _build.LaunchCounter(variants=("simt", "mma_bf16",
                                              "simt_bf16", "mma_f32"))
# ssd_bwd_mma: a block walks up to this many heads of one group, adding
# their dB and dC into one fp32 partial, while that leaves at least
# MMA_MIN_BLOCKS blocks (about one wave at two blocks an SM of the H100's
# 132).  Measured on the H100 at zamba2-1.2b's training shape (B 32, H 64,
# S 128; PERF.md): 8 heads a block 0.311 ms a call, 4 0.322, 1 0.341 (its
# partials' torch.sum 0.064 ms of it); at the full layer (B 4, S 4096)
# 1.41 ms at one head, 2.00 at two
MMA_MAX_HEADS = 8
MMA_MIN_BLOCKS = 256
# ssd_bwd_mma_f32 (one block of 191,008 bytes an SM at P = N = 64) walks
# one head a block: on the H100 two and four heads a block were slower at
# zamba2 10m's and 100m's training shapes and at the full layer (PERF.md)


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


def bwd_smem_bytes(P: int, N: int, variant: str = "simt") -> int:
    """Dynamic shared memory of one backward block, as the source sizes
    it.  ``"simt"`` / ``"simt_bf16"`` (``ssd_bwd_simt``,
    ``bwd_smem_floats``): x and dy, B and C, Gc and the chunk's start
    state, rows padded by one float; M, Q and Z, rows of 65; nine rows of
    64 (dt, seg, exp(seg), exp(seg_last - seg), q, beta, gamma and the
    rectangle sums) and eight partials, fp32.  ``"mma_bf16"``
    (``ssd_bwd_mma``, ``Tile``): x and dY's two terms [64][P], B and C
    [64][N], Gc's and h_s's two terms [P][N], Q^T o dt's two terms
    [64][64], bf16; then fp32 dt, each of the 4 warps' seg and column
    sums, the rectangle sums, q, beta and gamma (64 each), 4 partials, 4
    scratch tiles of 16 x 17 and Gc [P][N].  ``"mma_f32"``
    (``ssd_bwd_mma_f32``, ``TileF32``): three bf16 terms each of x and dY
    [64][P], B and C [64][N], Gc [P][N] and Q^T o dt [64][64], two of h_s
    [P][N]; then fp32 dt, each of the 8 warps' seg twice (hi and lo),
    pass A's 4 column-sum rows, the rectangle sums, q, beta and gamma (64
    each), 8 partials, pass A's 4 scratch tiles of 16 x 17 and Gc [P][N]
    (1,024 floats at P 32 / N 16: a warp's state tile at least)."""
    L = CHUNK
    if variant in ("simt", "simt_bf16"):
        return 4 * (2 * L * (P + 1) + 2 * L * (N + 1) + 2 * P * (N + 1)
                    + 3 * L * (L + 1) + 9 * L + 8)
    floats = L + 4 * L + 4 * L + 4 * L + 4 + 4 * 16 * 17 + P * N
    if variant == "mma_bf16":
        return 2 * (3 * L * P + 2 * L * N + 4 * P * N + 2 * L * L) \
            + 4 * floats
    if variant == "mma_f32":
        gc = -(-(N // 8) * (P // 16) // 8) * 4 * 256
        return 2 * (6 * L * P + 6 * L * N + 5 * P * N + 3 * L * L) \
            + 4 * (floats + 12 * L + 4 - P * N + gc)
    raise ValueError(f"unknown ssm_scan backward variant {variant!r}")


def bwd_variant(dtype: torch.dtype, variant: Optional[str] = None) -> str:
    """The backward variant a call of ``ssm_scan_bwd_cuda`` runs on x, B
    and C of ``dtype``: ``BWD_VARIANTS[dtype]`` unless one is named; fp32
    takes ``"mma_f32"`` or ``"simt"``, bf16 ``"mma_bf16"`` or
    ``"simt_bf16"`` (``BWD_ALLOWED``)."""
    if dtype not in BWD_VARIANTS:
        raise TypeError(f"ssm_scan_bwd cuda: takes float32 or bfloat16 x, "
                        f"Bm and Cm, got {dtype}")
    if variant is None:
        return BWD_VARIANTS[dtype]
    allowed = BWD_ALLOWED[dtype]
    if variant not in allowed:
        raise ValueError(f"ssm_scan_bwd cuda: variant {variant!r} does not "
                         f"take {dtype} (one of {allowed})")
    return variant


def heads_per_block(B: int, H: int, G: int) -> int:
    """How many heads of one group a ``ssd_bwd_mma`` block walks: the
    largest power of two dividing H / G, at most ``MMA_MAX_HEADS``, that
    leaves at least ``MMA_MIN_BLOCKS`` blocks (1 where even one head a
    block leaves fewer).  Its dB and dC partials are then (B, H / hpb, S,
    N) fp32 where one a head would be (B, H, S, N)."""
    rep, hpb = H // G, 1
    while 2 * hpb <= MMA_MAX_HEADS and rep % (2 * hpb) == 0 \
            and B * H // (2 * hpb) >= MMA_MIN_BLOCKS:
        hpb *= 2
    return hpb


def launch_shape(variant: str, B: int, H: int, G: int = 1):
    """(grid, threads a block) of one launch: the SIMT forward one block
    a (batch, head), the mma forward two (each half of P); the bf16
    tensor-core backward one block of 128 threads a (batch,
    ``heads_per_block`` heads of a group), the fp32 one a block of 256
    (passes A and B on a warpgroup each) a (batch, head)."""
    if variant == "simt":
        return (H, B), 256
    if variant == "mma_bf16":
        return (H // heads_per_block(B, H, G), B), 128
    if variant == "mma_f32":
        return (H, B), 256
    return (2 * H, B), 128


def rows_error(t: torch.Tensor) -> Optional[str]:
    """Why the mma kernels cannot read the rows of ``t`` 16 bytes at a
    time (cp.async of bf16 x, B and C; float4 loads of the backwards' fp32
    dy and of ``mma_f32``'s fp32 x, B and C), or None if they can: the
    last axis contiguous, every other stride a multiple of 16 bytes, a
    16-byte-aligned base."""
    per = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % per for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        return (f"must have a contiguous last axis, strides that are "
                f"multiples of {per} elements and a 16-byte-aligned base "
                f"(its rows are read 16 bytes at a time), got strides "
                f"{t.stride()}")
    return None


def _check_rows(name: str, t: torch.Tensor, what: str = "ssm_scan cuda"):
    why = rows_error(t)
    if why is not None:
        raise ValueError(f"{what}: {t.dtype} {name} {why}")


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
    y = _build.empty((B, S, H, P), torch.float32, dev).transpose(1, 2)
    if S == 0 or B == 0 or H == 0:
        hf = torch.zeros((B, H, P, N), dtype=torch.float32, device=dev) \
            if h0 is None else h0.clone()
        return y, hf
    hf = _build.empty((B, H, P, N), torch.float32, dev)
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


@functools.lru_cache(maxsize=None)
def _bwd_mma_entry(variant: str = "mma_bf16"):
    lib = _build.load("ssm_scan_bwd_mma")
    f32 = variant == "mma_f32"
    fn = lib.ssm_scan_bwd_mma_f32 if f32 else lib.ssm_scan_bwd_mma
    # B, H, G, S (and the bf16 kernel's heads a block)
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 15 + [
        ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int64] * (
            4 if f32 else 5) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssm_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor,
                      h0: Optional[torch.Tensor], dy: torch.Tensor,
                      dhf: Optional[torch.Tensor] = None,
                      variant: Optional[str] = None):
    """The gradient of ``ssm_scan_cuda``: the forward's inputs (x (B, H,
    S, P), dt (B, H, S), A (H,), Bm, Cm (B, G, S, N), h0 or None),
    ``dy`` (B, H, S, P) and ``dhf`` (B, H, P, N) or None (zeros), on one
    CUDA device -> (dx, ddt, dA, dB, dC, dh0), each shaped like its input
    and in its dtype (dh0 None when h0 is), dx, ddt, dB and dC views of
    the model's (B, S, ·) memory as y is.  x, Bm and Cm are fp32 or bf16
    (one dtype), dt fp32 or bf16, as ``ssm_scan_cuda`` takes them; A, h0,
    dy and dhf fp32.  ``variant`` (``bwd_variant``): fp32 runs
    ``"mma_f32"`` unless ``"simt"`` is named; bf16 ``"mma_bf16"`` unless
    ``"simt_bf16"`` is named.

    The kernels compute in fp32 and write dx and ddt in their inputs'
    dtypes, dA per (batch, head) and dB and dC as fp32 partial sums (one a
    head for SIMT and ``mma_f32``, one a block of ``heads_per_block``
    heads for ``mma_bf16``); the partials of a group and the batch are
    then summed here in fp32 by ``torch.sum``, whose reduction order is
    fixed (no atomics anywhere), so reruns are bit-identical, and dB and
    dC rounded once to Bm's dtype after the sum (``sum_partials``).
    Launches one kernel on the current stream (plus those sums) and does
    not synchronise."""
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
    variant = bwd_variant(x.dtype, variant)
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
        if variant in MMA_BWD:
            _check_rows(name, t, "ssm_scan_bwd cuda")
    if S == 0 or B == 0 or H == 0:
        dx = _build.empty((B, S, H, P), x.dtype, dev).transpose(1, 2)
        ddt = _build.empty((B, S, H), dt.dtype, dev).transpose(1, 2)
        zero = Bm.new_zeros(Bm.shape)
        dh0 = None if h0 is None else \
            dhf.clone() if dhf is not None else torch.zeros_like(h0)
        return dx, ddt, A.new_zeros(A.shape), zero, zero.clone(), dh0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        entry = _bwd_mma_entry(variant) if variant in MMA_BWD \
            else _bwd_entry()
        out = launch_bwd(entry, variant, x, dt, A, Bm, Cm, h0, dy, dhf,
                         stream)
    bwd_launches.add(variant)
    return out


def launch_bwd(entry, variant: str, x, dt, A, Bm, Cm, h0, dy, dhf,
               stream):
    """Allocate the backward's outputs and workspace, call ``entry`` (the
    C function of ``variant``) on ``stream``, and sum the partials: the
    part of ``ssm_scan_bwd_cuda`` after its checks."""
    B, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    dev = x.device
    mma = variant in MMA_BWD
    hpb = heads_per_block(B, H, G) if variant == "mma_bf16" else 1
    dx = _build.empty((B, S, H, P), x.dtype, dev).transpose(1, 2)
    ddt = _build.empty((B, S, H), dt.dtype, dev).transpose(1, 2)
    dBp, dCp = (_build.empty((B, S, H // hpb, N), torch.float32,
                             dev).transpose(1, 2) for _ in range(2))
    dA = _build.empty((B, H), torch.float32, dev)
    dh0 = None if h0 is None else _build.empty((B, H, P, N), torch.float32,
                                               dev)
    n_chunks = -(-S // CHUNK)
    # ssd_bwd_mma keeps the first and last chunk-start states off it
    n_ws = max(n_chunks - 2, 0) if mma else n_chunks
    ws = _build.empty((B, H, n_ws, P, N), torch.float32, dev) if n_ws \
        else None
    h0c = None if h0 is None else h0.contiguous()
    dhfc = None if dhf is None else dhf.contiguous()
    A32 = A.contiguous()
    strides = (ctypes.c_int64 * 27)(*(s for t in (x, dt, Bm, Cm, dy, dx,
                                                  ddt, dBp, dCp)
                                      for s in t.stride()[:3]))
    ptrs = [t if t is None else t.data_ptr() for t in (
        x, dt, A32, Bm, Cm, h0c, dy, dhfc, dx, ddt, dA, dBp, dCp, dh0, ws)]
    if variant == "mma_bf16":
        err = entry(DTYPES[dt.dtype], P, N, *ptrs, strides, B, H, G, S, hpb,
                    stream)
    elif mma:
        err = entry(DTYPES[dt.dtype], P, N, *ptrs, strides, B, H, G, S,
                    stream)
    else:
        err = entry(DTYPES[x.dtype], DTYPES[dt.dtype], P, N, *ptrs, strides,
                    B, H, G, S, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd cuda: {variant} launch failed "
                           f"with CUDA error {err} at x {tuple(x.shape)}, "
                           f"Bm {tuple(Bm.shape)}, {x.dtype}")
    dB, dC = (sum_partials(t, G, Bm.dtype) for t in (dBp, dCp))
    return dx, ddt, dA.sum(0), dB, dC, dh0


def sum_partials(per_head: torch.Tensor, G: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """The fp32 partials (B, Hp, S, N) of a group-shared input's gradient
    (a view of (B, S, Hp, N) memory; one a head, or one a block of heads,
    each group's Hp / G partials consecutive) summed over each group in
    fp32 by ``torch.sum`` (a fixed order), then rounded once to ``dtype``
    -> (B, G, S, N), a view of (B, S, G, N) memory."""
    B, H, S, N = per_head.shape
    rep = H // G
    total = per_head if rep == 1 else per_head.transpose(1, 2).reshape(
        B, S, G, rep, N).sum(3).transpose(1, 2)
    return total.to(dtype)
