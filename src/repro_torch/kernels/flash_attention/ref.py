"""Plain PyTorch oracle: dense softmax attention with causal/window masking.

The port of ``repro.kernels.flash_attention.ref.attention_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
# the bf16 flash kernel's gate: bf16_excess(kernel output, fp32 truth) at
# most this.  It lies between the kernel's readings on an H100 (two bf16
# terms of P) and those of a kernel that rounds P to one bf16 term
# (PERF.md)
BF16_FLOOR = 2.0 ** -12


def _masked_scores(q, k, causal, window, scale, q_offset):
    """The scaled scores (B, Hkv, G, Sq, Sk) with masked pairs at
    ``NEG_INF``, in fp32 (float64 for float64 q)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(f) * scale, k.to(f))
    qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return torch.where(ok, s, NEG_INF)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); GQA via head grouping.

    Returns (B, Hq, Sq, D) in q's dtype (fp32 softmax inside; float64
    for float64 inputs, a truth to hold the kernels to).  Masked scores
    take the finite ``NEG_INF``, so a row that sees no key averages V
    over every key.
    """
    s = _masked_scores(q, k, causal, window, scale, q_offset)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(s.dtype))
    return o.reshape(q.shape).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      scale: Optional[float] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """Each query row's log-sum-exp of the scaled, masked scores, (B, Hq,
    Sq) in fp32 (float64 for float64 q): what the forward kernels write
    under ``with_lse`` for the backward."""
    s = _masked_scores(q, k, causal, window, scale, q_offset)
    return torch.logsumexp(s, dim=-1).reshape(q.shape[:3])


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      window: Optional[int] = None,
                      scale: Optional[float] = None, q_offset: int = 0):
    """The plain backward of :func:`attention_ref`: (dq, dk, dv) for the
    output gradient ``dout``, by autograd through it in fp32 (float64 for
    float64 inputs) on the inputs upcast, each gradient then rounded once
    to its input's dtype.  For bf16 inputs this is what the bf16 backward
    kernel computes, save the softmax's row sum delta, which the kernel
    takes from the bf16 output.  The yardstick of
    ``flash_attention_bwd_cuda`` in the tests and ``chip_smoke.py``; the
    port's model never calls it."""
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    with torch.enable_grad():
        leaves = [x.detach().to(f).requires_grad_(True) for x in (q, k, v)]
        o = attention_ref(*leaves, causal=causal, window=window,
                          scale=scale, q_offset=q_offset)
        grads = torch.autograd.grad(o, leaves, dout.to(f))
    return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))


def _bf16_split(x: torch.Tensor, terms: int):
    """fp32 ``x`` as ``terms`` bf16 terms, each float64: t0 = bf16(x),
    t1 = bf16(x - t0), t2 = bf16(x - t0 - t1) (each remainder exact in
    fp32), as the kernels split their factors for the tensor cores."""
    out, rest = [], x.float()
    for _ in range(terms):
        t = rest.to(torch.bfloat16)
        out.append(t.double())
        rest = rest - t.float()
    return out


def _bf16_terms(x: torch.Tensor, terms: int) -> torch.Tensor:
    """fp32 ``x`` as the tensor cores take it in ``terms`` bf16 terms
    (``_bf16_split``), returned summed (float64)."""
    return sum(_bf16_split(x, terms))


def _toward_zero(y: torch.Tensor) -> torch.Tensor:
    """float64 ``y`` rounded to fp32 toward zero."""
    f = y.float()
    return torch.where(f.double().abs() > y.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _tc_pairs(terms: int):
    """The term products (i, j) with i + j <= terms - 1, the small ones
    first and the main pair (0, 0) last, as the kernels issue them."""
    return [(i, j) for i in range(terms) for j in range(terms)
            if 0 < i + j <= terms - 1] + [(0, 0)]


def _tc_into(acc: torch.Tensor, ai, bj, terms: int, lo: int,
             hi: int) -> torch.Tensor:
    """``acc`` (fp32) plus the term products of K columns lo..hi-1 of
    the split factors ``ai`` and ``bj``, one wgmma of 16 columns at a
    time, each sum exact and then truncated to fp32 toward zero."""
    for i, j in _tc_pairs(terms):
        for c0 in range(lo, hi, 16):
            c1 = min(c0 + 16, hi)
            acc = _toward_zero(acc.double() + ai[i][..., c0:c1]
                               @ bj[j][..., c0:c1, :])
    return acc


def _tc_product(a: torch.Tensor, b: torch.Tensor, terms: int,
                tile: int) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) of fp32 factors as the fp32 wgmma
    kernels form it: each factor in ``terms`` bf16 terms; K in tiles of
    ``tile``, each tile's term products (i + j <= terms - 1) summed into
    a zeroed partial one wgmma at a time, 16 columns of K a wgmma, the
    small pairs first and the main pair (0, 0) last; each wgmma's sum
    exact and then truncated to fp32 toward zero (Hopper's tensor cores
    truncate their sums; this is the worst case of that), and each tile's
    partial added to an fp32 sum rounded to nearest.  Returns fp32."""
    ai, bj = _bf16_split(a, terms), _bf16_split(b, terms)
    K = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) \
        + (a.shape[-2], b.shape[-1])
    acc = torch.zeros(shape, dtype=torch.float32)
    for t0 in range(0, K, tile):
        part = _tc_into(torch.zeros(shape, dtype=torch.float32), ai, bj,
                        terms, t0, min(t0 + tile, K))
        acc = (acc.double() + part.double()).float()
    return acc


LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
LN2 = torch.tensor(0.6931471805599453, dtype=torch.float32)


def fwd_f32_key_tile(D: int) -> int:
    """The kv tile of the fp32 tensor-core forward (``flash_fwd_f32``):
    64 keys at D <= 64, 32 above."""
    return 64 if D <= 64 else 32


def attention_fwd_f32_mirror(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None,
                             q_offset: int = 0, terms: int = 3,
                             chained: bool = False):
    """The rounding points of the fp32 tensor-core forward (variant
    ``wgmma_f32``, ``flash_fwd_f32`` in ``csrc/flash_attention.cu``), for
    tests only.  Returns (o, lse), fp32.

    S = Q K^T with Q and K in ``terms`` bf16 terms, summed as
    ``_tc_product`` sums them over all of D (bit for bit the scores the
    fp32 backward forms).  The online softmax runs over the kernel's kv
    tiles (``fwd_f32_key_tile``) in the log2 domain: x = fp32(S sl2) with
    sl2 = fp32(scale) * fp32(log2 e), a masked pair at fp32(-1e30 log2 e)
    (so a row that sees no key has lse -1e30 + log Sk); per tile the
    row max m, alpha = exp2(m_old - m) and p = exp2(x - m), each rounded
    to fp32 (the kernel's ex2.approx is within 2 ulp of that; not
    modelled); l kept as the four per-thread fp32 sums of the kernel's
    accumulator layout (columns 8j + 2qd + e of thread qd, added in
    order, l = fma(l, alpha, sum)) and reduced ((l0 + l1) + (l2 + l3)) at
    the end.  P V of each tile: P in ``terms`` terms into a zeroed
    partial (``_tc_product`` over the tile), then O = fma(O, alpha,
    partial) in fp32; with ``chained`` the products run straight into O
    instead (O rescaled in fp32, then every term product of every tile
    truncated into it), the design the kernel avoids.  o = O / max(l,
    1e-30) and lse = fma(m, ln 2, log l), as the kernel's epilogue.  q, k,
    v: fp32, (B, H, S, D) with GQA groups as in ``attention_ref``."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    bk = fwd_f32_key_tile(D)
    qg = q.float().reshape(B, Hkv, G, Sq, D)
    s = _tc_product(qg, k.float().transpose(-1, -2)[:, :, None], terms, D)
    sl2 = (torch.tensor(scale, dtype=torch.float32) * LOG2E).double()
    x = (s.double() * sl2).float()
    qp = q_offset + torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    neg = torch.tensor(NEG_INF, dtype=torch.float32) * LOG2E
    x = torch.where(ok, x, neg)
    vg = v.float()[:, :, None]
    m = torch.full((B, Hkv, G, Sq, 1), float(neg), dtype=torch.float32)
    lt = torch.zeros((B, Hkv, G, Sq, 4), dtype=torch.float32)
    o = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32)
    for k0 in range(0, Sk, bk):
        k1 = min(k0 + bk, Sk)
        xt = x[..., k0:k1]
        mx = torch.maximum(m, xt.amax(-1, keepdim=True))
        alpha = torch.exp2((m - mx).double()).float()
        p = torch.exp2((xt - mx).double()).float()
        sums = torch.zeros_like(lt)
        for j in range(0, k1 - k0, 8):
            for e in range(2):
                for qd in range(4):
                    c = j + 2 * qd + e
                    if c < k1 - k0:
                        sums[..., qd] = sums[..., qd] + p[..., c]
        lt = (lt.double() * alpha.double() + sums.double()).float()
        if chained:
            o = _tc_into(o * alpha, _bf16_split(p, terms),
                         _bf16_split(vg[..., k0:k1, :], terms), terms, 0,
                         k1 - k0)
        else:
            part = _tc_product(p, vg[..., k0:k1, :], terms, bk)
            o = (o.double() * alpha.double() + part.double()).float()
        m = mx
    l = (lt[..., 0] + lt[..., 1]) + (lt[..., 2] + lt[..., 3])
    l = l.clamp_min(1e-30)[..., None]
    lse = (m.double() * LN2.double()
           + torch.log(l.double()).float().double()).float()
    return (o / l).reshape(q.shape), lse.reshape(B, Hq, Sq)


def attention_bwd_f32_mirror(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None,
                             q_offset: int = 0, terms: int = 3,
                             lse: Optional[torch.Tensor] = None,
                             out: Optional[torch.Tensor] = None,
                             first_walk: bool = True):
    """The rounding points of the fp32 tensor-core backward (variant
    ``wgmma_f32`` of ``csrc/flash_attention_bwd.cu``), for tests only.

    Every factor of the products (Q, K, V, dO; P and dS formed in fp32)
    goes in ``terms`` bf16 terms, the term products with i + j <= terms
    - 1 summed as ``_tc_product`` sums them: S and dP over all of D, dQ
    in tiles of the kernel's key tile (64 keys at D <= 64, 32 above), dK
    and dV in tiles of 32 queries.

    ``lse`` is the forward's (B, Hq, Sq); by default the plain fp32
    attention's (``attention_lse_ref``), and the tests hand in
    ``attention_fwd_f32_mirror``'s, the pipeline as the port runs it.
    Either comes from other scores or sums than these, so it does not
    quite normalise them: e = exp(fp32(S scale - lse)), and a first walk
    over the keys takes each row's l = sum_j e and u = sum_j e dP in
    fp32; then r = 1 / l, delta = u r, P = e r and dS = P (dP - delta),
    all fp32, and dq = scale dQ, dk = scale dK.  Taking delta and the
    row sum from the same P keeps dS a softmax gradient (its row sums 0),
    which ``dO . out`` and the plain forward's lse alone do not: those put
    dq up to 2.4x as far from float64 as the plain fp32 attention.  With
    ``first_walk=False`` the dq kernel's first walk is left out: P = e
    and delta = fp32(sum_d dO out) from the forward's ``out``, which must
    then be given.  q, k, v, dout: fp32, (B, H, S, D) with GQA groups as
    in ``attention_ref``; a group's dK and dV summed over its heads in
    order, as one block of the kernel walks them."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    if lse is None:
        lse = attention_lse_ref(q, k, causal=causal, window=window,
                                scale=scale, q_offset=q_offset)
    qg = q.float().reshape(B, Hkv, G, Sq, D)
    dog = dout.float().reshape(B, Hkv, G, Sq, D)
    s = _tc_product(qg, k.float().transpose(-1, -2)[:, :, None], terms, D)
    dp = _tc_product(dog, v.float().transpose(-1, -2)[:, :, None], terms,
                     D)
    qp = q_offset + torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    arg = (s.double() * scale
           - lse.reshape(B, Hkv, G, Sq, 1).double()).float()
    e = torch.where(ok, torch.exp(arg.double()).float(), 0.0)
    if first_walk:
        row = e.double().sum(-1, keepdim=True).float()
        u = (e.double() * dp.double()).sum(-1, keepdim=True).float()
        r = 1.0 / row
        p = e * r
        ds = p * (dp - u * r)
    else:
        delta = (dog.double() * out.float().reshape(dog.shape).double()
                 ).sum(-1, keepdim=True).float()
        p = e
        ds = p * (dp - delta)
    # dV and dK: the group's heads one after another along the sum
    pt = p.permute(0, 1, 4, 2, 3).reshape(B, Hkv, Sk, G * Sq)
    dst = ds.permute(0, 1, 4, 2, 3).reshape(B, Hkv, Sk, G * Sq)
    dv = _tc_product(pt, dog.reshape(B, Hkv, G * Sq, D), terms, 32)
    dk = _tc_product(dst, qg.reshape(B, Hkv, G * Sq, D), terms, 32)
    dq = _tc_product(ds, k.float()[:, :, None], terms, 64 if D <= 64 else 32)
    return dq.reshape(q.shape) * scale, dk * scale, dv


def attention_bwd_wgmma_mirror(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, dout: torch.Tensor, *,
                               causal: bool = True,
                               window: Optional[int] = None,
                               scale: Optional[float] = None,
                               q_offset: int = 0, terms: int = 2):
    """The rounding points of the bf16 tensor-core backward
    (``flash_bwd_wgmma`` in ``csrc/flash_attention_bwd.cu``), for tests
    only: S = Q K^T and dP = dO V^T from the bf16 values with fp32 sums,
    P = exp(scale S - lse) and dS = P (dP - delta) in fp32 (delta = Σ P
    dP), then P and dS rounded to ``terms`` bf16 terms (2: hi + lo, as
    the kernel passes them to the tensor cores) before dV = P^T dO, dQ =
    scale dS K and dK = scale dS^T Q, which run in float64; each gradient
    rounded to bf16 once.  q, k, v, dout: bf16, (B, H, S, D) with GQA
    groups as in ``attention_ref``."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    f = torch.float32
    qg = q.float().reshape(B, Hkv, G, Sq, D)
    dog = dout.float().reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.float())
    qp = q_offset + torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    lse = torch.logsumexp(torch.where(ok, s, NEG_INF), dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - lse), 0.0).to(f)
    delta = (p.double() * dp.double()).sum(-1, keepdim=True)
    ds = (p.double() * (dp.double() - delta)).to(f)
    pr, dsr = _bf16_terms(p, terms), _bf16_terms(ds, terms)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", pr, dog.double())
    dq = torch.einsum("bhgqk,bhkd->bhgqd", dsr, k.double()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", dsr, qg.double()) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of ``x`` (fp32; 0 where ``x`` is 0):
    2^(e - 7) for 2^e <= |x| < 2^(e + 1)."""
    x = x.float()
    _, e = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def bf16_excess(got: torch.Tensor, truth: torch.Tensor) -> float:
    """How far a bf16 result strays beyond one bf16 ulp of the fp32
    truth, as a share of its row's largest |truth|: the max over elements
    of (|got - truth| - ulp(truth)) / max_d |truth[..., d]|.  At most 0
    when every element lies within one ulp of the truth (a correctly
    rounded result lies within half of one); the gate of the bf16 flash
    kernel holds it to ``BF16_FLOOR``, so an error that is small against
    the row's largest output but large against an element's own ulp
    still counts."""
    truth = truth.float()
    err = (got.float() - truth).abs() - bf16_ulp(truth)
    row = truth.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return float((err / row).max())


# The gate of a bf16 gradient (the flash and SSD backwards on bf16
# inputs): its excess beyond one bf16 ulp of the truth (autograd through
# the plain version in fp32 or float64 on the same bf16 values, upcast)
# within the fp32 kernel's tolerance of max(1, max |truth|) and within
# BF16_BWD_OWN_TOL of the tensor's own max |truth|, which a zero gradient
# fails; fp32 outputs (dA, dh0) without the ulp.  chip_smoke.py and the
# tests hold every bf16 backward to it
BF16_BWD_OWN_TOL = 1e-3


def bf16_grad_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over elements of |got - want| beyond one bf16 ulp of ``want``
    (``bf16_ulp``) where ``got`` is bf16; of |got - want| itself where it
    is fp32."""
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        err = (err - bf16_ulp(want)).clamp_min(0.0)
    return float(err.max()) if err.numel() else 0.0


def bf16_grad_gate(got: torch.Tensor, want: torch.Tensor, tol: float):
    """(excess, max |want|, passes) of one gradient under the gate above:
    the excess (``bf16_grad_excess``) within ``tol`` of max(1, max
    |want|) and within ``BF16_BWD_OWN_TOL`` of max |want|."""
    exc = bf16_grad_excess(got, want)
    top = float(want.abs().max()) if want.numel() else 0.0
    ok = exc <= tol * max(1.0, top) and exc <= BF16_BWD_OWN_TOL * top
    return exc, top, ok
