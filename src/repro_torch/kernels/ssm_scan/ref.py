"""Plain PyTorch oracle: the per-timestep Mamba2 SSD recurrence (exact,
sequential).

The port of ``repro.kernels.ssm_scan.ref.ssm_scan_ref``:

    h_t = exp(dt_t · A_h) · h_{t-1} + dt_t · x_t ⊗ B_t ;   y_t = C_t · h_t
"""
from __future__ import annotations

from typing import Optional

import torch


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 h0: Optional[torch.Tensor] = None):
    """x: (B, H, S, P); dt: (B, H, S); A: (H,) negative;
    Bm, Cm: (B, H, S, N) (groups pre-expanded to heads).
    Returns y (B, H, S, P) fp32 and the final state (B, H, P, N) fp32
    (float64 for float64 x, to check a gradient against)."""
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    h = torch.zeros((B, H, P, N), dtype=f, device=x.device) \
        if h0 is None else h0.to(f)
    xf, dtf, Bf, Cf, Af = (t.to(f) for t in (x, dt, Bm, Cm, A))
    ys = []
    for t in range(S):
        dtt = dtf[:, :, t]                                    # (B, H)
        da = torch.exp(dtt * Af[None, :])
        h = da[..., None, None] * h + torch.einsum(
            "bhp,bhn->bhpn", xf[:, :, t] * dtt[..., None], Bf[:, :, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, :, t]))
    y = torch.stack(ys, 2) if ys else xf.new_zeros((B, H, 0, P))
    return y, h


def ssm_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor,
                     h0: Optional[torch.Tensor], dy: torch.Tensor,
                     dhf: Optional[torch.Tensor] = None, chunk: int = 64):
    """The gradient of ``ssm_scan_ref`` in the order the backward kernel
    (``csrc/ssm_scan_bwd.cu``) takes it: a plain mirror of its two walks,
    for checking the algebra on the CPU.  Nothing on the card's path
    calls it.

    Shapes as ``ssm_scan_ref`` (groups expanded to heads); ``dy`` (B, H,
    S, P), ``dhf`` (B, H, P, N) or None (zeros).  Computes in float64 for
    float64 x and in fp32 otherwise (bf16 inputs widened, as the kernel
    does), and returns dx, ddt, dA (H,), dB, dC (per head) and dh0 (B, H,
    P, N), each rounded once to its input's dtype (dh0 fp32 when h0 is
    None).

    With a_t = exp(dt_t A), G_t = dL/dh_t = a_{t+1} G_{t+1} + dy_t C_tᵀ
    (G_S = dh_f): dx_t = dt_t G_t B_t, dB_t = dt_t G_tᵀ x_t, dC_t =
    h_tᵀ dy_t, ddt_t = x_tᵀ G_t B_t + A λ_t and dA = Σ dt_t λ_t, where
    λ_t = dL/d log a_t = ⟨G_t, a_t h_{t-1}⟩.

    The forward walk keeps each chunk's start state h_s; the reverse walk,
    per chunk of L rows with seg the within-chunk cumsum of dt A, e_τ =
    exp(seg_τ), w_t = exp(seg_last − seg_t), D[τ, t] = exp(seg_τ − seg_t)
    for t ≤ τ (else 0) and Gc the gradient of the chunk's end state from
    later chunks:
        M = (C Bᵀ) ∘ D,  Q = (dY Xᵀ) ∘ D,
        G_t B_t = (Mᵀ dY)_t + w_t Gc B_t,   G_tᵀ x_t = (Qᵀ C)_t + w_t Gcᵀ x_t,
        dC_τ = e_τ h_sᵀ dy_τ + Σ_l Q[τ, l] dt_l B_l,
        Gc ← e_last Gc + Σ_τ e_τ dy_τ C_τᵀ  (dh0 after chunk 0),
    and λ from the chunk's own terms (G_t and h_t expanded over the chunk,
    with w_t D[t, l] = w_l and e_t D[τ, t] = e_τ):
        λ_t = e_last ⟨Gc, h_s⟩ + Σ_{l≤t} w_l dt_l x_lᵀ Gc B_l
              + Σ_{τ≥t} e_τ dy_τᵀ h_s C_τ + Σ_{τ≥t} Σ_{l≤t} Z[τ, l]
              − dt_t x_tᵀ G_t B_t,
        Z[τ, l] = D[τ, l] dt_l (dy_τ·x_l)(C_τ·B_l).
    Every sum stays inside one chunk.  The shorter identity λ_t =
    Σ_{τ≥t} (C_τ·dC_τ − dt_τ x_τᵀ G_τ B_τ) + ⟨dh_f, h_f⟩ sums over all of
    S and cancels: in fp32 at S 4096 it left dA 1.2e-3 of max |dA| from
    float64."""
    dtypes = [t.dtype for t in (x, dt, A, Bm, Cm)]
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    x, dt, A, Bm, Cm, dy = (t.to(f) for t in (x, dt, A, Bm, Cm, dy))
    h0_dtype = torch.float32 if h0 is None else h0.dtype
    Bsz, H, S, P = x.shape
    N = Bm.shape[-1]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    h = torch.zeros((Bsz, H, P, N), dtype=f, device=x.device) \
        if h0 is None else h0.to(f)
    starts, chunks = [], []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        pad = chunk - (sl.stop - sl.start)

        def take(t, sl=sl, pad=pad):
            t = t[:, :, sl]
            return torch.nn.functional.pad(t, (0, 0, 0, pad)) \
                if t.ndim == 4 else torch.nn.functional.pad(t, (0, pad))
        xc, dtc, bc, cc, dyc = (take(t) for t in (x, dt, Bm, Cm, dy))
        seg = torch.cumsum(dtc * A[None, :, None], -1)        # (B,H,L)
        e, wl = torch.exp(seg), torch.exp(seg[..., -1:] - seg)
        starts.append(h)
        chunks.append((sl, xc, dtc, bc, cc, dyc, seg, e, wl))
        h = e[..., -1, None, None] * h + torch.einsum(
            "bhl,bhlp,bhln->bhpn", wl * dtc, xc, bc)
    gc = torch.zeros_like(h) if dhf is None else dhf.to(f)
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dB, dC = torch.zeros_like(Bm), torch.zeros_like(Cm)
    dA = torch.zeros((Bsz, H), dtype=f, device=x.device)
    for hs, (sl, xc, dtc, bc, cc, dyc, seg, e, wl) in zip(
            reversed(starts), reversed(chunks)):
        n = sl.stop - sl.start
        dmat = torch.where(mask, torch.exp(
            (seg[..., :, None] - seg[..., None, :]).masked_fill(~mask, 0)),
            0)                                                # D[τ, t]
        cb = torch.einsum("bhtn,bhln->bhtl", cc, bc)
        yx = torch.einsum("bhtp,bhlp->bhtl", dyc, xc)
        M, Q = cb * dmat, yx * dmat
        gcb = torch.einsum("bhln,bhpn->bhlp", bc, gc)         # Gc B_l
        gb = torch.einsum("bhtl,bhtp->bhlp", M, dyc) + wl[..., None] * gcb
        gx = torch.einsum("bhtl,bhtn->bhln", Q, cc) \
            + wl[..., None] * torch.einsum("bhlp,bhpn->bhln", xc, gc)
        dyh = torch.einsum("bhtp,bhpn->bhtn", dyc, hs)        # dy_τᵀ h_s
        dcc = e[..., None] * dyh + torch.einsum("bhtl,bhl,bhln->bhtn", Q,
                                                dtc, bc)
        q = (xc * gb).sum(-1)                                 # x_tᵀ G_t B_t
        beta = (xc * gcb).sum(-1)                             # x_lᵀ Gc B_l
        gamma = (cc * dyh).sum(-1)                            # dy_τᵀ h_s C_τ
        z = M * yx * dtc[..., None, :]                        # Z[τ, l]
        rect = z.cumsum(-1).flip(-2).cumsum(-2).flip(-2)      # [τ', t] sums
        lam = (e[..., -1, None] * (gc * hs).sum((-2, -1))[..., None]
               + (wl * dtc * beta).cumsum(-1)
               + (e * gamma).flip(-1).cumsum(-1).flip(-1)
               + torch.diagonal(rect, dim1=-2, dim2=-1) - dtc * q)
        dx[:, :, sl] = (dtc[..., None] * gb)[:, :, :n]
        dB[:, :, sl] = (dtc[..., None] * gx)[:, :, :n]
        dC[:, :, sl] = dcc[:, :, :n]
        ddt[:, :, sl] = (q + A[None, :, None] * lam)[:, :, :n]
        dA = dA + (dtc * lam).sum(-1)
        gc = e[..., -1, None, None] * gc + torch.einsum(
            "bht,bhtp,bhtn->bhpn", e, dyc, cc)
    return tuple(t.to(d) for t, d in zip(
        (dx, ddt, dA.sum(0), dB, dC, gc), dtypes + [h0_dtype]))


# The fp32 factors of ssd_bwd_mma's tensor-core products, each passed as
# bf16 terms (``mma::split<K>``): dy (dY in C Bᵀ's twin dY Xᵀ, in Mᵀ dY and
# in dY h_s), M = (C Bᵀ) ∘ D, Q = (dY Xᵀ) ∘ D (and Q ∘ dt in dC), the
# carried Gc, the chunk-start state h_s, e ∘ dy (the Gc update) and the
# forward walk's B ∘ w ∘ dt.  x, B and C are bf16 and exact.  The kernel's
# terms, the fewest with which this mirror passes ``bf16_grad_gate`` at
# 2e-4 (tests/test_torch_scan_grad.py)
MMA_FACTORS = ("dy", "m", "q", "gc", "hs", "edy", "bstate")
MMA_TERMS = {f: 2 for f in MMA_FACTORS}


def _terms(x: torch.Tensor, k: Optional[int]):
    """``x`` (float64) as the tensor cores take it: ``k`` bf16 terms, t0 =
    bf16(x), t1 = bf16(x − t0), …, each float64; ``[x]`` for None (no
    rounding)."""
    if k is None:
        return [x]
    out, rest = [], x
    for _ in range(k):
        t = rest.to(torch.bfloat16).double()
        out.append(t)
        rest = rest - t
    return out


def _mm(eq: str, a, b):
    """Σ einsum(eq, a_i, b_j) over the term pairs i + j < max(len(a),
    len(b)): the products the kernel issues (two fp32 factors in two terms
    each: hi·hi, hi·lo, lo·hi; lo·lo, 2^-18 of the product, is dropped)."""
    k = max(len(a), len(b))
    return sum(torch.einsum(eq, ai, bj) for i, ai in enumerate(a)
               for j, bj in enumerate(b) if i + j < k)


def ssm_scan_bwd_mma_mirror(x: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, Bm: torch.Tensor,
                            Cm: torch.Tensor, h0: Optional[torch.Tensor],
                            dy: torch.Tensor,
                            dhf: Optional[torch.Tensor] = None,
                            terms=MMA_TERMS, chunk: int = 64):
    """The rounding points of the bf16 tensor-core backward (``ssd_bwd_mma``
    in ``csrc/ssm_scan_bwd_mma.cu``), for tests only.  x (B, H, S, P), dt
    (B, H, S), A (H,), Bm, Cm (B, G, S, N) with head h reading group h //
    (H / G), h0 (B, H, P, N) or None, dy (B, H, S, P), dhf or None.

    Each fp32 factor of a tensor-core product (``MMA_FACTORS``) is rounded
    to ``terms[factor]`` bf16 terms where the kernel rounds it (``terms``
    an int for all of them, or None: no rounding), the products keep the
    term pairs the kernel issues (``_mm``), and the rest runs in float64:
    the decays, Z's row and column sums and λ.  dx and ddt are rounded
    once to their inputs' dtypes, dB and dC summed over each group's heads
    and then rounded once; dA (H,) and dh0 fp32 (float64 for float64 x).

    The kernel's algebra is ``ssm_scan_bwd_ref``'s, with every chunk
    product in the orientation a warp owning rows t forms it: Mᵀ[t, τ] =
    (B_t·C_τ) D[τ, t] and Qᵀ[t, τ] = (x_t·dY_τ) D[τ, t] for τ ≥ t, so
    G_t B_t = (Mᵀ dY)_t + w_t Gc B_t and G_tᵀ x_t = (Qᵀ C)_t + w_t Gcᵀ x_t
    from the warp's own rows, and dC_τ = e_τ (dY h_s)_τ + Σ_l (Qᵀ ∘
    dt)[l, τ] B_l through shared memory.  λ leaves out two terms that
    ``ssm_scan_bwd_ref``'s holds and that cancel in exact arithmetic, the
    row t of Z's rectangle and dt_t (Mᵀ dY)_t·x_t (the kernel would take
    one from the split M and the other from fp32: in this mirror their
    gap left dA 3e-4 of max |dA| from float64), with the w_t dt_t β_t that
    q_t also holds:
        λ_t = e_last ⟨Gc, h_s⟩ + Σ_{l<t} w_l dt_l β_l
              + Σ_{τ≥t} e_τ γ_τ + Σ_{l<t} Σ_{τ≥t} Zᵀ[l, τ].
    Z's rectangle sums are summed as they stand, never as a difference of
    prefix sums of its row and column sums: that difference cancels (in
    fp32 at S 2048 it left dA 3.7e-3 of max |dA| from float64, against
    6.3e-4 summed directly; measured with this mirror in fp32 on the
    CPU)."""
    if isinstance(terms, int) or terms is None:
        terms = {f: terms for f in MMA_FACTORS}
    dtypes = (x.dtype, dt.dtype, Bm.dtype)
    h0_dtype = torch.float32 if h0 is None else h0.dtype
    out64 = x.dtype == torch.float64
    Bsz, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    rep = H // G
    d = torch.float64
    x, dt, A, dy = (t.to(d) for t in (x, dt, A, dy))
    Bh, Ch = (t.to(d).repeat_interleave(rep, 1) for t in (Bm, Cm))
    L = chunk
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))   # [τ, t]: t ≤ τ
    h = torch.zeros((Bsz, H, P, N), dtype=d) if h0 is None else h0.to(d)
    chunks = []
    for c0 in range(0, S, L):
        sl = slice(c0, min(c0 + L, S))
        pad = L - (sl.stop - sl.start)

        def take(t, sl=sl, pad=pad):
            t = t[:, :, sl]
            return torch.nn.functional.pad(t, (0, 0, 0, pad)) \
                if t.ndim == 4 else torch.nn.functional.pad(t, (0, pad))
        xc, dtc, bc, cc, dyc = (take(t) for t in (x, dt, Bh, Ch, dy))
        seg = torch.cumsum(dtc * A[None, :, None], -1)
        e, wl = torch.exp(seg), torch.exp(seg[..., -1:] - seg)
        chunks.append((sl, h, xc, dtc, bc, cc, dyc, seg, e, wl))
        bw = _terms(bc * (wl * dtc)[..., None], terms["bstate"])
        h = e[..., -1, None, None] * h + _mm("bhlp,bhln->bhpn", [xc], bw)
    gc = torch.zeros_like(h) if dhf is None else dhf.to(d)
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dB, dC = torch.zeros_like(Bh), torch.zeros_like(Ch)
    dA = torch.zeros((Bsz, H), dtype=d)
    for sl, hs, xc, dtc, bc, cc, dyc, seg, e, wl in reversed(chunks):
        n = sl.stop - sl.start
        dmt = torch.where(tri, torch.exp(
            (seg[..., :, None] - seg[..., None, :]).masked_fill(~tri, 0)),
            0).transpose(-2, -1)                              # Dᵀ[t, τ]
        dyr = _terms(dyc, terms["dy"])
        gcr = _terms(gc, terms["gc"])
        cbt = torch.einsum("bhtn,bhun->bhtu", bc, cc)         # B_t·C_τ
        qt = _mm("bhtp,bhup->bhtu", [xc], dyr) * dmt          # Qᵀ
        mt = cbt * dmt                                        # Mᵀ
        z = cbt * qt * dtc[..., None]                         # Zᵀ[t, τ]
        rect = torch.diagonal(z.flip(-1).cumsum(-1).flip(-1).cumsum(-2),
                              dim1=-2, dim2=-1) - z.sum(-1)   # rows l < t
        gbo = _mm("bhtn,bhpn->bhtp", [bc], gcr)               # Gc B_t
        gb = _mm("bhtu,bhup->bhtp", _terms(mt, terms["m"]), dyr) \
            + wl[..., None] * gbo
        gx = _mm("bhtu,bhun->bhtn", _terms(qt, terms["q"]), [cc]) \
            + wl[..., None] * _mm("bhtp,bhpn->bhtn", [xc], gcr)
        dco = _mm("bhup,bhpn->bhun", dyr, _terms(hs, terms["hs"]))
        dcc = e[..., None] * dco + _mm(
            "bhtu,bhtn->bhun", _terms(qt * dtc[..., None], terms["q"]), [bc])
        q = (xc * gb).sum(-1)
        beta = (xc * gbo).sum(-1)
        gamma = (cc * dco).sum(-1)
        wdb = wl * dtc * beta
        lam = (e[..., -1, None] * (gc * hs).sum((-2, -1))[..., None]
               + (wdb.cumsum(-1) - wdb)
               + (e * gamma).flip(-1).cumsum(-1).flip(-1) + rect)
        dx[:, :, sl] = (dtc[..., None] * gb)[:, :, :n]
        dB[:, :, sl] = (dtc[..., None] * gx)[:, :, :n]
        dC[:, :, sl] = dcc[:, :, :n]
        ddt[:, :, sl] = (q + A[None, :, None] * lam)[:, :, :n]
        dA = dA + (dtc * lam).sum(-1)
        gc = e[..., -1, None, None] * gc + _mm(
            "bhtp,bhtn->bhpn", _terms(e[..., None] * dyc, terms["edy"]),
            [cc])
    dB, dC = (t.reshape(Bsz, G, rep, S, N).sum(2) for t in (dB, dC))
    f = torch.float64 if out64 else torch.float32
    return (dx.to(dtypes[0]), ddt.to(dtypes[1]), dA.sum(0).to(f),
            dB.to(dtypes[2]), dC.to(dtypes[2]), gc.to(h0_dtype))


# The factors of the fp32 tensor-core backward's products (``ssd_bwd_mma``
# on fp32 x, B and C, variant ``mma_f32``): x, B and C themselves, and the
# fp32 factors of the bf16 kernel (``MMA_FACTORS``).  The kernel's terms,
# the fewest with which ``ssm_scan_bwd_f32_mirror`` lies within 2x of
# ``ssm_scan_bwd_ref``'s fp32 distance from float64 at every shape of
# tests/test_torch_scan_grad.py: three for each factor, two for the chunk-
# start state h_s and the forward walk's B o w o dt
F32_FACTORS = ("x", "b", "c") + MMA_FACTORS
F32_TERMS = dict({f: 3 for f in F32_FACTORS}, hs=2, bstate=2)


def _tc_mm(a: torch.Tensor, b: torch.Tensor, ka: Optional[int],
           kb: Optional[int], acc: Optional[torch.Tensor] = None,
           per_step: bool = False):
    """a (..., M, K) @ b (..., K, N) as ``ssd_bwd_mma_f32`` forms it:
    a in ``ka`` and b in ``kb`` bf16 terms, each k-step of 16 columns'
    term products (``flash_attention.ref._tc_pairs``) issued small pairs
    first, every ``mma``'s sum exact and then truncated to fp32 toward
    zero, into ``acc`` (fp32) or a zeroed partial; with ``per_step`` each
    k-step's products into a zeroed partial of their own, added to
    ``acc`` rounded to nearest.  ``ka`` None: exact (no terms, no
    truncation), in a's dtype."""
    from repro_torch.kernels.flash_attention.ref import (_bf16_split,
                                                         _tc_into)
    if ka is None:
        out = a @ b
        return out if acc is None else acc + out
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) \
        + (a.shape[-2], b.shape[-1])
    if acc is None:
        acc = torch.zeros(shape, dtype=torch.float32)
    ai, bj = _bf16_split(a, ka), _bf16_split(b, kb)
    K = a.shape[-1]
    if not per_step:
        return _tc_into(acc, ai, bj, 0, K, k_outer=True)
    for c0 in range(0, K, 16):
        acc = acc + _tc_into(torch.zeros(shape, dtype=torch.float32), ai,
                             bj, c0, min(c0 + 16, K))
    return acc


def _seg2(a: torch.Tensor):
    """The inclusive cumsum of ``a`` (fp32) over its last axis as the
    kernel's compensated scan keeps it: an unevaluated sum hi + lo of two
    fp32 values, modelled as the float64 cumsum split once (float64 a:
    (cumsum, 0))."""
    s = torch.cumsum(a.double(), -1)
    if a.dtype == torch.float64:
        return s, torch.zeros_like(s)
    hi = s.float()
    return hi, (s - hi.double()).float()


def _sub2(a, b):
    """(a_hi - b_hi) + (a_lo - b_lo) in the working dtype: the difference
    of two compensated sums, which keeps the digits a plain difference of
    two large cumsums cancels."""
    return (a[0] - b[0]) + (a[1] - b[1])


def _exp2(a):
    """exp2 of a value or of a compensated sum (hi, lo): exp2(hi)
    exp2(lo)."""
    if isinstance(a, tuple):
        return torch.exp2(a[0]) * torch.exp2(a[1])
    return torch.exp2(a)


def _fma(a, b, c):
    """a b + c rounded once, in a's dtype (fp32: an ``fmaf``)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def ssm_scan_bwd_f32_mirror(x: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, Bm: torch.Tensor,
                            Cm: torch.Tensor, h0: Optional[torch.Tensor],
                            dy: torch.Tensor,
                            dhf: Optional[torch.Tensor] = None,
                            terms=F32_TERMS, chained: bool = False,
                            chunk: int = 64):
    """The rounding points of the fp32 tensor-core backward
    (``ssd_bwd_mma_f32`` in ``csrc/ssm_scan_bwd_mma.cu``, variant
    ``mma_f32``), for tests only.  x (B, H, S, P), dt (B, H, S), A (H,),
    Bm, Cm (B, G, S, N) with head h reading group h // (H / G), h0 (B, H,
    P, N) or None, dy (B, H, S, P), dhf or None, all fp32 (dt fp32 or
    bf16).

    ``ssm_scan_bwd_mma_mirror``'s algebra, with its rounding where the
    fp32 kernel rounds: every product's factors (``F32_FACTORS``, x, B
    and C among them) in ``terms[factor]`` bf16 terms (``terms`` an int
    for all, or None: exact), summed as ``_tc_mm`` sums them, each
    chunk's products into a zeroed partial; the within-chunk cumsum of dt
    A log2 e kept as a compensated pair (``_seg2``) and every decay exp2
    of a difference of two such (``_sub2``); λ, Z's rectangle sums and
    every elementwise step in fp32, the kernel's fmas rounded once.  The
    two sums carried from chunk to chunk, h ← e_last h + Xᵀ (B ∘ w ∘ dt)
    walking forward and Gc ← e_last Gc + (e ∘ dY)ᵀ C walking back, take
    each k-step's products as a zeroed partial added rounded to nearest;
    with ``chained`` the products run straight into e_last h and e_last
    Gc instead (the bf16 kernel's form).  dB and dC are summed over each
    group's heads in fp32, dA over the batch.  Float64 inputs with
    ``terms=None`` run all of it in float64: ``ssm_scan_bwd_ref``'s
    algebra.  Returns dx, ddt, dA (H,), dB, dC, dh0 (fp32; float64 for
    float64 x)."""
    if isinstance(terms, int) or terms is None:
        terms = {f: terms for f in F32_FACTORS}
    t = terms
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    dt_dtype = dt.dtype
    Bsz, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    rep = H // G
    x, dt, dy = (v.to(f) for v in (x, dt, dy))
    A = A.to(f)
    A2 = A * torch.tensor(1.4426950408889634, dtype=f)
    Bh, Ch = (v.to(f).repeat_interleave(rep, 1) for v in (Bm, Cm))
    L = chunk
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))   # [τ, t]: t ≤ τ
    upper = tri.T                                            # [t, τ]: τ ≥ t
    h = torch.zeros((Bsz, H, P, N), dtype=f) if h0 is None else h0.to(f)
    chunks = []
    for c0 in range(0, S, L):
        sl = slice(c0, min(c0 + L, S))
        pad = L - (sl.stop - sl.start)

        def take(v, sl=sl, pad=pad):
            v = v[:, :, sl]
            return torch.nn.functional.pad(v, (0, 0, 0, pad)) \
                if v.ndim == 4 else torch.nn.functional.pad(v, (0, pad))
        xc, dtc, bc, cc, dyc = (take(v) for v in (x, dt, Bh, Ch, dy))
        seg = _seg2(dtc * A2[None, :, None])                # log2 units
        e = _exp2(seg)
        wl = _exp2(_sub2(tuple(v[..., -1:] for v in seg), seg))
        chunks.append((sl, h, xc, dtc, bc, cc, dyc, seg, e, wl))
        if c0 + L < S:
            bw = bc * (wl * dtc)[..., None]
            h = _tc_mm(xc.transpose(-1, -2), bw, t["x"], t["bstate"],
                       acc=h * e[..., -1, None, None], per_step=not chained)
    gc = torch.zeros_like(h) if dhf is None else dhf.to(f)
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dB, dC = torch.zeros_like(Bh), torch.zeros_like(Ch)
    dA = torch.zeros((Bsz, H), dtype=f)
    for sl, hs, xc, dtc, bc, cc, dyc, seg, e, wl in reversed(chunks):
        n = sl.stop - sl.start
        dmt = torch.where(upper, _exp2(_sub2(
            tuple(v[..., None, :] for v in seg),
            tuple(v[..., :, None] for v in seg)).masked_fill(~upper, 0)),
            0)                                               # Dᵀ[t, τ]
        cbt = _tc_mm(bc, cc.transpose(-1, -2), t["b"], t["c"])  # B_t·C_τ
        qt = _tc_mm(xc, dyc.transpose(-1, -2), t["x"], t["dy"]) * dmt
        mt = cbt * dmt
        z = cbt * qt * dtc[..., None]                        # Zᵀ[t, τ]
        sfx = z.flip(-1).cumsum(-1).flip(-1)                 # Σ_{τ≥u}
        rect = torch.cat([torch.zeros_like(sfx[..., 0, :1]),
                          torch.diagonal(sfx.cumsum(-2)[..., :-1, 1:],
                                         dim1=-2, dim2=-1)], -1)
        gbo = _tc_mm(bc, gc.transpose(-1, -2), t["b"], t["gc"])  # B Gcᵀ
        g = _fma(wl[..., None].expand_as(gbo), gbo,
                 _tc_mm(mt, dyc, t["m"], t["dy"]))           # G_t B_t
        gxo = _tc_mm(xc, gc, t["x"], t["gc"])                # X Gc
        gx = _fma(wl[..., None].expand_as(gxo), gxo,
                  _tc_mm(qt, cc, t["q"], t["c"]))            # G_tᵀ x_t
        dco = _tc_mm(dyc, hs, t["dy"], t["hs"])              # dY h_s
        gamma = (cc * dco).sum(-1)
        dcc = _tc_mm((qt * dtc[..., None]).transpose(-1, -2), bc, t["q"],
                     t["b"], acc=dco * e[..., None])
        q = (xc * g).sum(-1)
        beta = (xc * gbo).sum(-1)
        wdb = wl * dtc * beta
        lam = ((e[..., -1, None] * (gc * hs).sum((-2, -1))[..., None]
                + torch.cat([torch.zeros_like(wdb[..., :1]),
                             wdb.cumsum(-1)[..., :-1]], -1))
               + (e * gamma).flip(-1).cumsum(-1).flip(-1)) + rect
        dx[:, :, sl] = (dtc[..., None] * g)[:, :, :n]
        dB[:, :, sl] = (dtc[..., None] * gx)[:, :, :n]
        dC[:, :, sl] = dcc[:, :, :n]
        ddt[:, :, sl] = _fma(A[None, :, None].expand_as(lam), lam, q)[:, :,
                                                                       :n]
        dA = dA + (dtc * lam).sum(-1)
        edy = e[..., None] * dyc
        gc = _tc_mm(edy.transpose(-1, -2), cc, t["edy"], t["c"],
                    acc=gc * e[..., -1, None, None], per_step=not chained)
    dB, dC = (v.reshape(Bsz, G, rep, S, N).sum(2) for v in (dB, dC))
    return dx, ddt.to(dt_dtype if f == torch.float32 else f), dA.sum(0), \
        dB, dC, gc


def ssm_scan_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor,
                         h0: Optional[torch.Tensor] = None,
                         chunk: int = 64):
    """The chunked form as ``ssd_fwd_simt`` (``csrc/ssm_scan.cu``) takes
    it, in x's dtype (fp32: that kernel's algebra, the yardstick of the
    fp32 tensor-core forward; float64: exact), for tests only.  Shapes as
    ``ssm_scan_ref`` but Bm, Cm (B, G, S, N) with head h reading group h
    // (H / G).  Per chunk: seg the plain cumsum of dt A, M = (C Bᵀ) ∘
    exp(seg_i − seg_l) for l ≤ i, y = M (x dt) + exp(seg_i) C stateᵀ and
    state ← exp(seg_last) state + Σ_l exp(seg_last − seg_l) (x_l dt_l) ⊗
    B_l.  Returns y (B, H, S, P) and the final state (B, H, P, N)."""
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    Bsz, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    rep = H // G
    x, dt, A = (v.to(f) for v in (x, dt, A))
    Bh, Ch = (v.to(f).repeat_interleave(rep, 1) for v in (Bm, Cm))
    L = chunk
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))   # [i, l]: l ≤ i
    h = torch.zeros((Bsz, H, P, N), dtype=f) if h0 is None else h0.to(f)
    y = torch.zeros((Bsz, H, S, P), dtype=f)
    for c0 in range(0, S, L):
        sl = slice(c0, min(c0 + L, S))
        n, pad = sl.stop - sl.start, L - (sl.stop - sl.start)

        def take(v, sl=sl, pad=pad):
            v = v[:, :, sl]
            return torch.nn.functional.pad(v, (0, 0, 0, pad)) \
                if v.ndim == 4 else torch.nn.functional.pad(v, (0, pad))
        xc, dtc, bc, cc = (take(v) for v in (x, dt, Bh, Ch))
        seg = torch.cumsum(dtc * A[None, :, None], -1)
        e = torch.exp(seg)
        dec = torch.exp((seg[..., :, None] - seg[..., None, :])
                        .masked_fill(~tri, 0)).masked_fill(~tri, 0)
        xdt = xc * dtc[..., None]
        yc = (cc @ bc.transpose(-1, -2) * dec) @ xdt \
            + e[..., None] * (cc @ h.transpose(-1, -2))
        y[:, :, sl] = yc[:, :, :n]
        wl = torch.exp(seg[..., -1:] - seg)
        h = e[..., -1, None, None] * h \
            + (xdt * wl[..., None]).transpose(-1, -2) @ bc
    return y, h


# The factors of the fp32 tensor-core forward's products (``ssd_fwd_mma_f32``
# in csrc/ssm_scan.cu): x, B and C; the chunk-start state in C stateᵀ;
# M' = (C Bᵀ) ∘ decay ∘ dt in M' x; and B ∘ w ∘ dt in the state update.
# The kernel's terms: the fewest with which ``ssm_scan_fwd_f32_mirror``
# keeps y and the final state within 2x of ``ssm_scan_chunked_ref``'s fp32
# distance from float64 at every shape of tests/test_torch_ssm_scan.py
FWD_F32_FACTORS = ("x", "b", "c", "state", "m", "bstate")
FWD_F32_TERMS = {f: 3 for f in FWD_F32_FACTORS}


def ssm_scan_fwd_f32_mirror(x: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, Bm: torch.Tensor,
                            Cm: torch.Tensor,
                            h0: Optional[torch.Tensor] = None,
                            terms=FWD_F32_TERMS, per_step: bool = True,
                            chunk: int = 64):
    """The rounding points of the fp32 tensor-core forward
    (``ssd_fwd_mma_f32`` in ``csrc/ssm_scan.cu``, variant ``mma_f32``),
    for tests only.  Shapes as ``ssm_scan_chunked_ref``; fp32 x, B, C,
    A and h0, fp32 or bf16 dt.

    Per chunk of ``chunk`` rows: seg the within-chunk cumsum of dt A
    log2 e, kept as a compensated pair (``_seg2``), every decay exp2 of a
    difference of two such (``_sub2``); C Bᵀ, C stateᵀ (skipped on chunk
    0 without h0) and M' x (M' = (C Bᵀ) ∘ decay ∘ dt, formed in fp32),
    every factor in ``terms[factor]`` bf16 terms (``terms`` an int for
    all, or None: exact), each k-step's products into a zeroed partial
    added rounded to nearest as ``_tc_mm`` sums them (``per_step`` False:
    a product's k-steps into one zeroed partial), y = fma(e, C stateᵀ,
    M' x) in fp32; the carried state ← e_last state + Xᵀ (B ∘ w ∘ dt),
    each k-step's products a zeroed partial.  Float64 inputs with
    ``terms=None`` run all of it in float64: ``ssm_scan_ref``'s
    function.  Returns y (B, H, S, P) and the final state (B, H, P, N),
    fp32 (float64 for float64 x)."""
    if isinstance(terms, int) or terms is None:
        terms = {f: terms for f in FWD_F32_FACTORS}
    t = terms
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    Bsz, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    rep = H // G
    x, dt, A = (v.to(f) for v in (x, dt, A))
    A2 = A * torch.tensor(1.4426950408889634, dtype=f)
    Bh, Ch = (v.to(f).repeat_interleave(rep, 1) for v in (Bm, Cm))
    L = chunk
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))   # [i, l]: l ≤ i
    h = torch.zeros((Bsz, H, P, N), dtype=f) if h0 is None else h0.to(f)
    y = torch.zeros((Bsz, H, S, P), dtype=f)
    for c0 in range(0, S, L):
        sl = slice(c0, min(c0 + L, S))
        n, pad = sl.stop - sl.start, L - (sl.stop - sl.start)

        def take(v, sl=sl, pad=pad):
            v = v[:, :, sl]
            return torch.nn.functional.pad(v, (0, 0, 0, pad)) \
                if v.ndim == 4 else torch.nn.functional.pad(v, (0, pad))
        xc, dtc, bc, cc = (take(v) for v in (x, dt, Bh, Ch))
        seg = _seg2(dtc * A2[None, :, None])                # log2 units
        e = _exp2(seg)
        dec = torch.where(tri, _exp2(_sub2(
            tuple(v[..., :, None] for v in seg),
            tuple(v[..., None, :] for v in seg)).masked_fill(~tri, 0)), 0)
        wl = _exp2(_sub2(tuple(v[..., -1:] for v in seg), seg))
        cb = _tc_mm(cc, bc.transpose(-1, -2), t["c"], t["b"],
                    per_step=per_step)
        m = cb * dec * dtc[..., None, :]
        intra = _tc_mm(m, xc, t["m"], t["x"], per_step=per_step)
        if c0 == 0 and h0 is None:
            yc = intra
        else:
            inter = _tc_mm(cc, h.transpose(-1, -2), t["c"], t["state"],
                           per_step=per_step)
            yc = _fma(e[..., None].expand_as(inter), inter, intra)
        y[:, :, sl] = yc[:, :, :n]
        bw = bc * (wl * dtc)[..., None]
        h = _tc_mm(xc.transpose(-1, -2), bw, t["x"], t["bstate"],
                   acc=h * e[..., -1, None, None], per_step=True)
    return y, h
