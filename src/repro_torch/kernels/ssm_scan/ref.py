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
