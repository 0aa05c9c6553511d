"""Launch wrapper of the CUDA ``flash_attention`` kernel
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py:69
flash_attention_pallas``.  The variant follows the dtype
(``VARIANTS``), with no fallback between variants: bf16 inputs launch
``flash_fwd_wgmma`` (tensor cores, TMA; P carried as two bf16 terms,
each output held to one bf16 ulp of ``attention_ref``'s fp32 result
plus a small floor, see ``ref.bf16_excess``), fp32 inputs
``flash_fwd_f32`` (``"wgmma_f32"``: the same design on fp32 values, a
pre-pass writing k and v as three bf16 terms each to workspaces, q split
so by the kernel once a block, P in registers, the term products with i
+ j <= 2 summed in fp32, each kv tile's P V into a zeroed partial;
float64 mirror ``ref.attention_fwd_f32_mirror``).  ``flash_fwd_simt``, the
Pallas kernel's fp32 arithmetic on SIMT FMAs, runs only where asked for
by name (``variant="simt"``), the yardstick of the tests and
``chip_smoke.py``.  All take strided (B, H, S, D) views whose last axis
is contiguous, so the model's (B, S, H, D) projections go in without a
transpose; see the source for the design and its bound.

Every variant can also write each row's log-sum-exp (``with_lse``),
which ``flash_attention_bwd_cuda`` (``csrc/flash_attention_bwd.cu``)
takes to form dq, dk and dv: the backward of the training forward.  Both
dtypes run it on the tensor cores (TMA and wgmma): bf16 as
``flash_bwd_wgmma`` (P and dS as two bf16 terms, each gradient rounded
to bf16 once), fp32 as ``flash_bwd_f32`` (every factor, the inputs and
P and dS, as three bf16 terms, the term products with i + j <= 2 summed
in fp32; a pre-pass writes the inputs' terms to bf16 workspaces).  The
SIMT kernels run only where asked for by name (``variant="simt"`` on
fp32, ``"simt_bf16"`` on bf16 values widened as they load), the
yardsticks of the tests and ``chip_smoke.py``.  The JAX package has no
backward kernel (its model trains through plain JAX attention);
``bwd_launches`` counts this one's calls by the variant they took.
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
# the forward variant of each dtype, and those a caller may name
VARIANTS = {torch.float32: "wgmma_f32", torch.bfloat16: "wgmma"}
FWD_ALLOWED = {torch.float32: ("wgmma_f32", "simt"),
               torch.bfloat16: ("wgmma",)}

launches = _build.LaunchCounter(variants=("wgmma", "wgmma_f32", "simt"))
launches_by_variant = launches.by_variant
# the launches above that also wrote each row's log-sum-exp (``with_lse``,
# the training forward), by variant
lse_launches = _build.LaunchCounter(variants=("wgmma", "wgmma_f32",
                                              "simt"))
# one count a call of flash_attention_bwd_cuda (its kernels: the fp32
# variant's split, dq, dk/dv), by variant: the tensor cores by default on
# either dtype, SIMT only where asked for by name
BWD_VARIANTS = {torch.float32: "wgmma_f32", torch.bfloat16: "wgmma_bf16"}
bwd_launches = _build.LaunchCounter(variants=("wgmma_f32", "simt",
                                              "wgmma_bf16", "simt_bf16"))
# the wgmma backward's dk/dv blocks own one query head each (fp32
# partials, summed over the group by ``sum_group_partials``) where a
# block a (batch, kv head, 64-key tile) would make fewer than this many
# blocks: two waves of the H100's 132 SMs for bf16, one for fp32 (whose
# three-term K and V tiles make a head's own block dearer: at the fp32
# training shapes a group a block was 1.06-1.33x faster, PERF.md)
PER_HEAD_BELOW = 264
PER_HEAD_BELOW_F32 = 132


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                   ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fwd_f32_entry():
    fn = _build.load("flash_attention").flash_attention_fwd_f32
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int64] * 7 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10 + [
        ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int64] * 7 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_f32_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_f32
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 16 + [
        ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int64] * 7 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_wgmma_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_wgmma
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [
        ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int64] * 7 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(variant: str, D: int) -> int:
    """Dynamic shared memory of one block, as ``csrc/flash_attention.cu``
    sizes it: SIMT, the fp32 Q, K^T and V tiles; wgmma, the Q tile of 128
    rows and 3 stages of K and V tiles of 64 keys (128 at D <= 64, 32 at
    D 192) in
    64-column boxes, 1024 bytes of alignment slack and the mbarriers;
    wgmma_f32, the same in three bf16 terms: the Q tile of 128 rows at D
    <= 64 and 64 above, K and V tiles of 64 keys at D <= 64 and 32 above,
    in 3 stages (2 at D 192)."""
    if variant == "simt":
        return (64 * D + max(D, 64) * 68 + 64 * D) * 4
    boxes = -(-D // 64)
    if variant == "wgmma_f32":
        rows, keys = (128, 64) if boxes == 1 else (64, 32)
        stages = 2 if boxes == 3 else 3
        return 1024 + 3 * boxes * rows * 128 \
            + stages * 2 * 3 * boxes * keys * 128 + 8 * 2 * stages
    keys = {1: 128, 2: 64}.get(boxes, 32)
    return 1024 + boxes * 128 * 128 + 3 * 2 * boxes * keys * 128 + 8 * 7


def bwd_smem_bytes(D: int, kernel: str = "simt") -> int:
    """Dynamic shared memory of one block of a backward kernel, as
    ``csrc/flash_attention_bwd.cu`` sizes it.  ``"simt"`` (dq and dk/dv
    alike): two 64 x D row tiles, two D x 68 transposed tiles, a 64 x 68
    tile of P or dS, lse and delta, fp32.  ``"wgmma_dq"``: the Q and dO
    tiles of 128 rows and 3 stages of K and V tiles; ``"wgmma_dkdv"``:
    the K and V tiles of 64 keys and 3 stages of Q and dO tiles; bf16 in
    64-column boxes, the streamed tiles 64 rows (32 at D 192), 1024 bytes
    of alignment slack and 7 mbarriers.  ``"f32_dq"`` / ``"f32_dkdv"``
    (the fp32 variant): the same tiles in three bf16 terms each, dq's
    resident tiles 128 rows at D <= 64 and 64 above, the streamed tiles 64
    rows at D <= 64 and 32 above, in 2 / 3 stages at D <= 64, 2 / 2 at D
    80 and 128, 1 / 1 at D 192."""
    if kernel == "simt":
        return (2 * 64 * D + 2 * D * 68 + 64 * 68 + 2 * 64) * 4
    boxes = -(-D // 64)
    if kernel in ("f32_dq", "f32_dkdv"):
        streamed = 64 if boxes == 1 else 32
        if kernel == "f32_dq":
            rows, stages = (128 if boxes == 1 else 64), (1 if boxes == 3
                                                         else 2)
        else:
            rows, stages = 64, {1: 3, 2: 2}.get(boxes, 1)
        return 1024 + 2 * 3 * boxes * rows * 128 \
            + stages * 2 * 3 * boxes * streamed * 128 + 8 * (2 * stages + 1)
    rows = {"wgmma_dq": 128, "wgmma_dkdv": 64}[kernel]
    streamed = 32 if boxes == 3 else 64
    return 1024 + 2 * boxes * rows * 128 + 3 * 2 * boxes * streamed * 128 \
        + 8 * 7


def fwd_variant(dtype: torch.dtype, variant: Optional[str] = None) -> str:
    """The forward variant a call of ``flash_attention_cuda`` runs:
    ``VARIANTS[dtype]`` unless one is named; fp32 takes ``"wgmma_f32"``
    or ``"simt"``, bf16 ``"wgmma"``."""
    if dtype not in VARIANTS:
        raise TypeError(f"flash_attention cuda: takes float32 or bfloat16, "
                        f"got {dtype}")
    if variant is None:
        return VARIANTS[dtype]
    if variant not in FWD_ALLOWED[dtype]:
        raise ValueError(f"flash_attention cuda: variant {variant!r} does "
                         f"not take {dtype} (one of {FWD_ALLOWED[dtype]})")
    return variant


def bwd_variant(dtype: torch.dtype, variant: Optional[str] = None) -> str:
    """The backward variant a call of ``flash_attention_bwd_cuda`` runs:
    ``BWD_VARIANTS[dtype]`` unless one is named; fp32 takes
    ``"wgmma_f32"`` or ``"simt"``, bf16 ``"wgmma_bf16"`` or
    ``"simt_bf16"``."""
    if dtype not in BWD_VARIANTS:
        raise TypeError(f"flash_attention_bwd cuda: takes float32 or "
                        f"bfloat16, got {dtype}")
    if variant is None:
        return BWD_VARIANTS[dtype]
    allowed = ("wgmma_f32", "simt") if dtype == torch.float32 \
        else ("wgmma_bf16", "simt_bf16")
    if variant not in allowed:
        raise ValueError(f"flash_attention_bwd cuda: variant {variant!r} "
                         f"does not take {dtype} (one of {allowed})")
    return variant


def per_head_blocks(B: int, Hq: int, Hkv: int, Sk: int,
                    dtype: torch.dtype = torch.bfloat16) -> bool:
    """Do the tensor-core backwards' dk/dv blocks own one query head each?
    Where G = Hq / Hkv > 1 and one block a (batch, kv head, 64-key tile)
    would give under ``PER_HEAD_BELOW`` blocks (``PER_HEAD_BELOW_F32`` for
    fp32): then a block walks one head of its group instead of all G in
    turn, and the G fp32 partials are summed by ``sum_group_partials``."""
    below = PER_HEAD_BELOW_F32 if dtype == torch.float32 else PER_HEAD_BELOW
    return Hq > Hkv and B * Hkv * -(-Sk // 64) < below


def sum_group_partials(part: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(B, Hq, Sk, D) fp32 per-query-head partials of dK or dV -> (B,
    Hkv, Sk, D) fp32: each group's G heads summed in fp32 by ``torch.sum``
    over the group axis (an order fixed by the shapes), before a bf16
    gradient's one rounding."""
    B, Hq, Sk, D = part.shape
    return part.view(B, Hkv, Hq // Hkv, Sk, D).sum(2)


def tma_layout_error(shape, strides, data_ptr: int,
                     element_size: int = 2) -> Optional[str]:
    """Why TMA cannot read a (B, H, S, D) view, or None if it can.

    TMA wants the last axis contiguous, a 16-byte-aligned base and every
    other stride a positive multiple of 16 bytes below 2**40; the stride
    of an axis of length 1 is never used (the kernel replaces it)."""
    if strides[-1] != 1:
        return f"the last axis must be contiguous, got strides {strides}"
    if data_ptr % 16:
        return (f"the base address must be 16-byte aligned, got "
                f"{data_ptr} ({data_ptr % 16} past a multiple of 16)")
    for n, st in zip(shape[:-1], strides[:-1]):
        nbytes = st * element_size
        if n > 1 and (st <= 0 or nbytes % 16 or nbytes >= 2 ** 40):
            return (f"every stride of an axis longer than 1 must be a "
                    f"positive multiple of 16 bytes below 2**40, got "
                    f"strides {strides} at {element_size} bytes an "
                    f"element")
    return None


def _check_layout(name: str, x: torch.Tensor):
    """The fp32 kernels (the SIMT ones, the split pre-passes of the
    tensor-core ones) read rows of 4 elements at a time and store rows of
    2: the last axis contiguous, the other strides and the base address
    aligned to 4 elements.  bf16 q, k and v are read by the wgmma
    variant's TMA (``tma_layout_error``), which asks more."""
    strides = x.stride()
    if x.dtype == torch.bfloat16 and name in ("q", "k", "v"):
        why = tma_layout_error(tuple(x.shape), strides, x.data_ptr(),
                               x.element_size())
        if why is not None:
            raise ValueError(f"flash_attention cuda: {name} cannot be read "
                             f"by TMA: {why}")
        return
    if strides[-1] != 1 or any(s % 4 for s in strides[:-1]) \
            or x.data_ptr() % (4 * x.element_size()):
        raise ValueError(f"flash_attention cuda: {name} must have a "
                         f"contiguous last axis and 4-element-aligned "
                         f"strides and base, got strides {strides}")


def _check_inputs(q, k, v, window):
    """The checks the forward and the backward share; returns (B, Hq,
    Hkv, Sq, Sk, D)."""
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
    return B, Hq, Hkv, Sq, Sk, D


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         q_offset: int = 0, with_lse: bool = False,
                         variant: Optional[str] = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) on one CUDA device ->
    (B, Hq, Sq, D) in q's dtype, laid out like q (``empty_like``); with
    ``with_lse`` also each row's log-sum-exp of the scaled, masked scores
    (natural log, from any variant), a contiguous (B, Hq, Sq) fp32
    tensor, as a pair.

    ``variant`` (default ``VARIANTS[dtype]``, ``fwd_variant``): bf16
    launches ``"wgmma"``; fp32 launches ``"wgmma_f32"``, which first
    writes k and v as three bf16 terms each to workspaces of 6 bytes an
    element (``flash_split3``; the kernel splits q itself), or ``"simt"``
    where a comparison names it.  A failed launch raises; no variant stands in for another.
    Launches on the current stream and does not synchronise."""
    B, Hq, Hkv, Sq, Sk, D = _check_inputs(q, k, v, window)
    variant = fwd_variant(q.dtype, variant)
    dev = q.device
    out = _build.empty_like(q)
    lse = _build.empty((B, Hq, Sq), torch.float32, dev) \
        if with_lse else None

    def result():
        return (out, lse) if with_lse else out

    if B == 0 or Hq == 0 or Sq == 0:
        return result()
    if Sk == 0:               # an empty softmax: the plain version's zeros
        out.zero_()
        if with_lse:
            lse.fill_(float("-inf"))
        return result()
    _check_layout("out", out)
    if scale is None:
        scale = D ** -0.5
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    window = 0 if window is None else int(window)
    lse_ptr = None if lse is None else lse.data_ptr()
    if variant == "wgmma_f32":
        planes = [_build.empty((3, *x.shape), torch.bfloat16, dev)
                  for x in (k, v)]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = _fwd_f32_entry()(
                D, *(x.data_ptr() for x in (q, k, v, out)), lse_ptr,
                *(x.data_ptr() for x in planes), strides, B, Hq, Hkv, Sq,
                Sk, int(q_offset), window, int(causal), float(scale),
                stream)
    else:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = _entry()(DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), out.data_ptr(), lse_ptr, strides,
                           B, Hq, Hkv, Sq, Sk, int(q_offset), window,
                           int(causal), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention cuda: {variant} "
                           f"launch failed with error {err} (a CUDA error; "
                           f"10000: no tensor-map encoder, 20000 + n: "
                           f"CUresult n encoding a tensor map) at q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype}")
    launches.add(variant)
    if with_lse:
        lse_launches.add(variant)
    return result()


def rows_without_keys(Sq: int, Sk: int, q_offset: int, causal: bool,
                      window: Optional[int]) -> bool:
    """Does some query row qp = q_offset + i (i < Sq) see no key of
    [0, Sk)?  Causal hides every key from qp < 0; a window W hides them
    from qp >= Sk + W - 1."""
    if Sq == 0:
        return False
    if Sk == 0 or (causal and q_offset < 0):
        return True
    return window is not None and q_offset + Sq - 1 >= Sk + window - 1


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None,
                             q_offset: int = 0,
                             variant: Optional[str] = None):
    """The gradient of ``flash_attention_cuda``: q, out, dout (B, Hq, Sq,
    D), k, v (B, Hkv, Sk, D), all fp32 or all bf16, and ``lse`` (B, Hq,
    Sq) fp32, the forward's ``with_lse`` output, on one CUDA device ->
    (dq, dk, dv), each laid out like its input (``empty_like``) and in
    its dtype, each rounded once from its fp32 sum.

    ``variant`` (default ``BWD_VARIANTS[dtype]``): the tensor-core
    kernels, ``"wgmma_f32"`` for fp32 and ``"wgmma_bf16"`` for bf16 (a
    first walk of the dq kernel forms delta from P and dP, and for fp32
    also each row's sum of P, so that P and delta come from the kernel's
    own scores; a GQA group's dK and dV summed in fp32 inside a block, or
    per query head and then by ``sum_group_partials`` where
    ``per_head_blocks``); or the SIMT kernels, which nothing but a
    comparison asks for: ``"simt"`` for fp32 (delta from ``out``),
    ``"simt_bf16"`` on bf16 values widened as they load.  bf16 dout must
    be readable by TMA (``tma_layout_error``) for the wgmma variant.
    ``"wgmma_f32"`` first writes q, k, v and dout as three bf16 terms
    each to a workspace of 6 bytes an element of the four
    (``flash_split3``), with two (B, Hq, Sq) fp32 vectors beside it.

    It computes what autodiff of ``ref.attention_ref`` computes, except
    for a query row that sees no key, where the plain version averages V
    over every key: such calls (``rows_without_keys``) are refused with a
    ``ValueError``; training never makes one.  Launches its kernels on
    the current stream and does not synchronise."""
    variant = bwd_variant(q.dtype, variant)
    B, Hq, Hkv, Sq, Sk, D = _check_inputs(q, k, v, window)
    for name, x in (("out", out), ("dout", dout)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_bwd cuda: {name} must be "
                             f"like q {tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        _check_layout(name, x)
    if variant == "wgmma_bf16":
        why = tma_layout_error(tuple(dout.shape), dout.stride(),
                               dout.data_ptr(), dout.element_size())
        if why is not None:
            raise ValueError(f"flash_attention_bwd cuda: dout cannot be "
                             f"read by TMA: {why}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd cuda: lse must be a "
                         f"contiguous ({B}, {Hq}, {Sq}) float32 tensor on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype}")
    if rows_without_keys(Sq, Sk, q_offset, causal, window):
        raise ValueError(f"flash_attention_bwd cuda: some query row sees "
                         f"no key (Sq {Sq}, Sk {Sk}, q_offset {q_offset}, "
                         f"causal {causal}, window {window}); the kernel "
                         f"does not take the plain version's mean of V "
                         f"over every key")
    dq, dk, dv = (_build.empty_like(x) for x in (q, k, v))
    if B == 0 or Hq == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    for name, x in (("dq", dq), ("dk", dk), ("dv", dv)):
        _check_layout(name, x)
    if scale is None:
        scale = D ** -0.5
    delta = _build.empty((B, Hq, Sq), torch.float32, q.device)
    window = 0 if window is None else int(window)
    if variant == "wgmma_f32":
        per_head = per_head_blocks(B, Hq, Hkv, Sk, torch.float32)
        parts = [_build.empty((B, Hq, Sk, D), torch.float32, q.device)
                 for _ in range(2)] \
            if per_head else [None, None]
        planes = [_build.empty((3, *x.shape), torch.bfloat16, q.device)
                  for x in (q, k, v, dout)]
        rinv = _build.empty((B, Hq, Sq), torch.float32, q.device)
        strides = (ctypes.c_int64 * 21)(*(st for x in (q, k, v, dout, dq,
                                                       dk, dv)
                                          for st in x.stride()[:3]))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _bwd_f32_entry()(
                D, *(x.data_ptr() for x in (q, k, v, dout, *planes, lse,
                                            rinv, delta, dq, dk, dv)),
                *(None if x is None else x.data_ptr() for x in parts),
                strides, B, Hq, Hkv, Sq, Sk, int(q_offset), window,
                int(causal), float(scale), int(per_head), stream)
        if err == 0 and per_head:
            dk.copy_(sum_group_partials(parts[0], Hkv))
            dv.copy_(sum_group_partials(parts[1], Hkv))
    elif variant == "wgmma_bf16":
        per_head = per_head_blocks(B, Hq, Hkv, Sk)
        parts = [_build.empty((B, Hq, Sk, D), torch.float32, q.device)
                 for _ in range(2)] \
            if per_head else [None, None]
        strides = (ctypes.c_int64 * 21)(*(st for x in (q, k, v, dout, dq,
                                                       dk, dv)
                                          for st in x.stride()[:3]))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _bwd_wgmma_entry()(
                D, *(x.data_ptr() for x in (q, k, v, dout, lse, delta, dq,
                                            dk, dv)),
                *(None if x is None else x.data_ptr() for x in parts),
                strides, B, Hq, Hkv, Sq, Sk, int(q_offset), window,
                int(causal), float(scale), int(per_head), stream)
        if err == 0 and per_head:
            dk.copy_(sum_group_partials(parts[0], Hkv))
            dv.copy_(sum_group_partials(parts[1], Hkv))
    else:
        strides = (ctypes.c_int64 * 24)(*(st for x in (q, k, v, out, dout,
                                                       dq, dk, dv)
                                          for st in x.stride()[:3]))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _bwd_entry()(DTYPES[q.dtype], D, *(x.data_ptr() for x in (
                q, k, v, out, dout, lse, delta, dq, dk, dv)), strides, B,
                Hq, Hkv, Sq, Sk, int(q_offset), window, int(causal),
                float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd cuda: {variant} launch "
                           f"failed with error {err} (a CUDA error; 10000: "
                           f"no tensor-map encoder, 20000 + n: CUresult n "
                           f"encoding a tensor map) at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype}")
    bwd_launches.add(variant)
    return dq, dk, dv
