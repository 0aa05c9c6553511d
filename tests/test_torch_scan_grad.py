"""The gradients of the two scans, on the CPU.

* The port's plain scans (``ssm_scan_ref``, ``rwkv6_scan_ref``) under
  autograd against ``jax.grad`` through the JAX package's
  ``repro.kernels.{ssm_scan,rwkv6_scan}.ref`` on the same numpy inputs,
  with and without an initial state and a final-state gradient: within
  1e-5 of max(1, max |g|) (fp32 both sides, other summation orders).
* The plain mirrors of the backward kernels' walks
  (``ssm_scan_bwd_ref``, ``rwkv6_scan_bwd_ref``) against autograd through
  the per-step oracles in float64: within 1e-10 of max(1, max |g|)
  (the algebra, with rounding out of the way).
* The mirrors in fp32 against float64 at long S (SSD 2048, WKV 2048):
  the cancellation the kernels' sums could suffer.  Measured: the SSD's
  within-chunk λ 2.4e-6–9e-6 of max(1, max |g|) at S 1024–4096, the
  WKV's dlogw identity 1.6e-6; held to 2e-5, a tenth of the card's 2e-4
  / 1e-4 gates.
* ``SSDScanFn`` / ``WKV6ScanFn``'s plumbing (argument order, model-layout
  views, the group sum, a missing final-state gradient) with the two
  launch wrappers replaced by CPU stand-ins: the Function's gradient
  equals autograd through the plain version.

The kernels themselves are held to autograd through the oracles on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as jax_wkv_ref
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssd_ref

from repro_torch.kernels.rwkv6_scan import ops as WO
from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_scan_bwd_ref,
                                                rwkv6_scan_ref)
from repro_torch.kernels.ssm_scan import ops as SO
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

GRAD_TOL = 1e-5        # fp32 autograd against jax.grad
ALGEBRA_TOL = 1e-10    # float64 mirror against float64 autograd
LONG_TOL = 2e-5        # fp32 mirror against float64 at long S


def _ssd_inputs(B, H, S, P, N, seed, h0=True, dhf=True):
    """numpy float64: x, dt (softplus), A < 0, B, C (groups expanded), h0,
    dy, dh_f (None where not asked for)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, S, P) * 0.5
    dt = np.log1p(np.exp(rng.randn(B, H, S)))
    A = -np.exp(rng.rand(H) * 2.8)
    Bm, Cm = rng.randn(B, H, S, N) * 0.5, rng.randn(B, H, S, N) * 0.5
    hh = rng.randn(B, H, P, N) if h0 else None
    dy = rng.randn(B, H, S, P)
    dh = rng.randn(B, H, P, N) if dhf else None
    return x, dt, A, Bm, Cm, hh, dy, dh


def _wkv_inputs(B, H, S, D, seed, s0=True, dsf=True, lo=-1.0):
    """numpy float64: r, k, v, logw = -exp(U(lo, 0)) (decays down to
    exp(-exp(lo)), long memory for lo far below 0), u, s0, dy, dS_f."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, H, S, D) * 0.5 for _ in range(3))
    logw = -np.exp(rng.uniform(lo, 0.0, (B, H, S, D)))
    u = rng.randn(H, D) * 0.5
    ss = rng.randn(B, H, D, D) * 0.5 if s0 else None
    dy = rng.randn(B, H, S, D)
    ds = rng.randn(B, H, D, D) if dsf else None
    return r, k, v, logw, u, ss, dy, ds


def _t(a, dtype=torch.float64):
    return None if a is None else torch.tensor(a, dtype=dtype)


def _autograd(fn, args, dy, dlast):
    """Gradients of <fn(*args)[0], dy> + <fn(*args)[1], dlast> with
    respect to every non-None argument (None where the argument is)."""
    leaves = [None if a is None else a.detach().clone().requires_grad_(True)
              for a in args]
    y, last = fn(*leaves)
    loss = (y * dy).sum() + ((last * dlast).sum() if dlast is not None
                             else 0.0)
    live = [a for a in leaves if a is not None]
    got = iter(torch.autograd.grad(loss, live))
    return [None if a is None else next(got) for a in leaves]


def _jax_grads(fn, args, dy, dlast):
    live = [i for i, a in enumerate(args) if a is not None]

    def loss(*xs):
        full = list(args)
        for i, x in zip(live, xs):
            full[i] = x
        y, last = fn(*full)
        out = jnp.sum(y * dy)
        return out + (jnp.sum(last * dlast) if dlast is not None else 0.0)
    grads = jax.grad(loss, argnums=tuple(range(len(live))))(
        *(jnp.asarray(args[i]) for i in live))
    out = [None] * len(args)
    for i, g in zip(live, grads):
        out[i] = np.asarray(g)
    return out


def _assert_close(got, want, tol, names):
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        err = np.abs(g - w).max() / max(1.0, np.abs(w).max())
        assert err <= tol, f"{name}: {err:.3e} of max(1, max |g|)"


SSD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")
WKV_NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")


@pytest.mark.parametrize("S,P,N,h0,dhf", [
    (37, 8, 4, True, True), (20, 4, 6, False, False),
    (33, 8, 4, False, True), (9, 4, 4, True, False)])
def test_ssd_plain_gradient_matches_jax_grad(S, P, N, h0, dhf):
    x, dt, A, Bm, Cm, hh, dy, dh = (
        a if a is None else a.astype(np.float32)
        for a in _ssd_inputs(2, 3, S, P, N, seed=S, h0=h0, dhf=dhf))
    got = _autograd(ssm_scan_ref, [_t(a, torch.float32) for a in
                                   (x, dt, A, Bm, Cm, hh)],
                    _t(dy, torch.float32), _t(dh, torch.float32))
    want = _jax_grads(jax_ssd_ref, [x, dt, A, Bm, Cm, hh], jnp.asarray(dy),
                      None if dh is None else jnp.asarray(dh))
    _assert_close(got, want, GRAD_TOL, SSD_NAMES)


@pytest.mark.parametrize("S,D,s0,dsf", [
    (29, 8, True, True), (17, 4, False, False), (40, 8, False, True),
    (6, 4, True, False)])
def test_wkv_plain_gradient_matches_jax_grad(S, D, s0, dsf):
    r, k, v, lw, u, ss, dy, ds = (
        a if a is None else a.astype(np.float32)
        for a in _wkv_inputs(2, 3, S, D, seed=S, s0=s0, dsf=dsf))
    got = _autograd(rwkv6_scan_ref, [_t(a, torch.float32) for a in
                                     (r, k, v, lw, u, ss)],
                    _t(dy, torch.float32), _t(ds, torch.float32))
    want = _jax_grads(jax_wkv_ref, [r, k, v, lw, u, ss], jnp.asarray(dy),
                      None if ds is None else jnp.asarray(ds))
    _assert_close(got, want, GRAD_TOL, WKV_NAMES)


# (S, P, N, chunk): ragged and whole chunks, a single row, P 32 / N 16
@pytest.mark.parametrize("S,P,N,chunk,h0,dhf", [
    (150, 8, 4, 64, True, True), (64, 4, 4, 64, False, False),
    (7, 4, 3, 64, True, False), (130, 4, 4, 64, False, True),
    (1, 4, 4, 64, True, True), (70, 32, 16, 32, True, True)])
def test_ssd_mirror_matches_autograd_in_float64(S, P, N, chunk, h0, dhf):
    x, dt, A, Bm, Cm, hh, dy, dh = (
        _t(a) for a in _ssd_inputs(2, 2, S, P, N, seed=S + P, h0=h0,
                                   dhf=dhf))
    want = _autograd(ssm_scan_ref, [x, dt, A, Bm, Cm, hh], dy, dh)
    got = ssm_scan_bwd_ref(x, dt, A, Bm, Cm, hh, dy, dh, chunk=chunk)
    if hh is None:
        got = list(got[:5]) + [None]
    _assert_close(got, want, ALGEBRA_TOL, SSD_NAMES)


@pytest.mark.parametrize("S,D,s0,dsf", [
    (40, 8, True, True), (17, 4, False, False), (5, 4, True, False),
    (1, 8, False, True), (33, 32, True, True)])
def test_wkv_mirror_matches_autograd_in_float64(S, D, s0, dsf):
    r, k, v, lw, u, ss, dy, ds = (
        _t(a) for a in _wkv_inputs(2, 2, S, D, seed=S + D, s0=s0, dsf=dsf))
    want = _autograd(rwkv6_scan_ref, [r, k, v, lw, u, ss], dy, ds)
    got = rwkv6_scan_bwd_ref(r, k, v, lw, u, ss, dy, ds)
    if ss is None:
        got = list(got[:5]) + [None]
    _assert_close(got, want, ALGEBRA_TOL, WKV_NAMES)


def _long_errors(names, got, want):
    """Each gradient's error relative to max(1, max |g|), by name."""
    return {n: float((g.double() - w).abs().max()
                     / max(1.0, float(w.abs().max())))
            for n, g, w in zip(names, got, want) if w is not None}


def test_ssd_mirror_in_fp32_at_long_s():
    """fp32 against float64 at S 2048, P = N = 64: λ's sums stay within a
    chunk, so dA (a sum of dt λ over all of S) keeps fp32's accuracy;
    the identity that sums λ over all of S left it 1.2e-3 off."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = [_t(a) for a in _ssd_inputs(1, 2, 2048, 64, 64, seed=5,
                                           h0=False, dhf=False)]
        want = ssm_scan_bwd_ref(*args)
        got = ssm_scan_bwd_ref(*[None if a is None else a.float()
                                 for a in args])
    finally:
        torch.set_num_threads(threads)
    errors = _long_errors(SSD_NAMES, got, want)
    assert max(errors.values()) <= LONG_TOL, errors


@pytest.mark.parametrize("lo", [-1.0, -9.0])
def test_wkv_mirror_in_fp32_at_long_s(lo):
    """fp32 against float64 at S 2048, D 64, decays down to exp(-exp(lo)):
    dlogw is a difference of two reverse cumulative sums; its
    cancellation stays near fp32's own rounding (1.6e-6 of max |dlogw|
    measured)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = [_t(a) for a in _wkv_inputs(1, 1, 2048, 64, seed=7,
                                           s0=False, dsf=True, lo=lo)]
        want = rwkv6_scan_bwd_ref(*args)
        got = rwkv6_scan_bwd_ref(*[None if a is None else a.float()
                                   for a in args])
    finally:
        torch.set_num_threads(threads)
    errors = _long_errors(WKV_NAMES, got, want)
    assert max(errors.values()) <= LONG_TOL, errors


def test_ssd_chunked_gradient_is_finite_past_exp_overflow():
    """The model's plain chunked SSD (``models.ssm._ssd_chunked``, the CPU
    and ``attn_impl="torch"`` path) at decay spans past exp's range (dt
    ~4, A -2: a span of ~250 over a chunk of 32): its gradient is finite
    and equals the per-step oracle's.  The reference's chunked form takes
    exp above the diagonal before it masks, and its gradient is NaN
    there."""
    from repro_torch.models.ssm import _ssd_chunked
    rng = np.random.RandomState(11)
    B, S, H, P, N = 2, 80, 2, 4, 4
    base = [torch.tensor(rng.randn(B, S, H, P), dtype=torch.float32),
            torch.tensor(np.log1p(np.exp(rng.randn(B, S, H) + 4.0)),
                         dtype=torch.float32),
            torch.tensor([-2.0, -1.5], dtype=torch.float32),
            torch.tensor(rng.randn(B, S, 1, N), dtype=torch.float32),
            torch.tensor(rng.randn(B, S, 1, N), dtype=torch.float32)]
    dy = torch.tensor(rng.randn(B, S, H, P), dtype=torch.float32)
    grads = []
    for form in ("chunked", "per-step"):
        leaves = [t.clone().requires_grad_(True) for t in base]
        if form == "chunked":
            y, _ = _ssd_chunked(*leaves, chunk=32)
        else:
            y, _ = SO.ssm_scan(*leaves, impl="torch")
        grads.append(torch.autograd.grad((y * dy).sum(), leaves))
    span = float((base[1] * base[2]).abs()[:, :32].sum(1).max())
    assert span > 88.0
    # dA within 2e-3: the chunked form's exponents are differences of
    # within-chunk cumsums near -250, and their backward cancels (8.3e-4 of
    # max(1, |dA|) from float64 measured, the per-step form 3.5e-7); the
    # other gradients within the forward's 2e-4
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), *grads):
        assert bool(torch.isfinite(g).all()), name
        tol = 2e-3 if name == "dA" else 2e-4
        assert float((g - w).abs().max()) <= tol * max(
            1.0, float(w.abs().max())), name


def _ssd_stand_ins(monkeypatch):
    """The two launch wrappers replaced by CPU stand-ins with their
    contracts: the forward by the oracle (groups expanded), the backward
    by the mirror with the heads of each group summed."""
    def fwd(x, dt, A, Bm, Cm, h0=None):
        rep = x.shape[1] // Bm.shape[1]
        return ssm_scan_ref(x, dt, A, Bm.repeat_interleave(rep, 1),
                            Cm.repeat_interleave(rep, 1), h0)

    def bwd(x, dt, A, Bm, Cm, h0, dy, dhf):
        B, H, S, _ = x.shape
        G, N = Bm.shape[1], Bm.shape[3]
        out = ssm_scan_bwd_ref(x, dt, A, Bm.repeat_interleave(H // G, 1),
                               Cm.repeat_interleave(H // G, 1), h0, dy, dhf)
        dB, dC = (t.reshape(B, G, H // G, S, N).sum(2) for t in out[3:5])
        return out[0], out[1], out[2], dB, dC, out[5] if h0 is not None \
            else None
    monkeypatch.setattr(SO, "ssm_scan_cuda", fwd)
    monkeypatch.setattr(SO, "ssm_scan_bwd_cuda", bwd)


@pytest.mark.parametrize("h0", [False, True])
def test_ssd_function_plumbing(monkeypatch, h0):
    """Model layout in (views of one projection, as ``ssm_forward`` makes
    them), G 2 with H 4, the final state unused: the Function's gradients
    equal autograd through the plain version."""
    _ssd_stand_ins(monkeypatch)
    rng = np.random.RandomState(3)
    B, S, H, P, N, G = 2, 70, 4, 8, 4, 2
    xbc = torch.tensor(rng.randn(B, S, H * P + 2 * G * N) * 0.5)
    dtv = torch.tensor(np.log1p(np.exp(rng.randn(B, S, H))))
    A = torch.tensor(-np.exp(rng.rand(H)))
    hh = torch.tensor(rng.randn(B, H, P, N)) if h0 else None
    dy = torch.tensor(rng.randn(B, S, H, P))
    grads = []
    for fn in ("function", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (xbc, dtv, A)] + \
            ([hh.clone().requires_grad_(True)] if h0 else [])
        x, Bm, Cm = torch.split(leaves[0], [H * P, G * N, G * N], -1)
        x, Bm, Cm = (x.reshape(B, S, H, P), Bm.reshape(B, S, G, N),
                     Cm.reshape(B, S, G, N))
        h = leaves[3] if h0 else None
        if fn == "function":
            y, _ = SO.SSDScanFn.apply(x.transpose(1, 2),
                                      leaves[1].transpose(1, 2), leaves[2],
                                      Bm.transpose(1, 2), Cm.transpose(1, 2),
                                      h)
            y = y.transpose(1, 2)
        else:
            y, _ = SO.ssm_scan(x, leaves[1], leaves[2], Bm, Cm, h,
                               impl="torch")
        grads.append(torch.autograd.grad((y * dy).sum(), leaves))
    for g, w in zip(*grads):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= ALGEBRA_TOL * max(
            1.0, float(w.abs().max()))


def test_wkv_function_plumbing(monkeypatch):
    """Model layout in through ``wkv_kernel_adapter`` with the launch
    wrappers replaced by the oracle and the mirror: the same gradients as
    the adapter's plain version, s0 set, the final state unused."""
    monkeypatch.setattr(WO, "rwkv6_scan_cuda", rwkv6_scan_ref)
    monkeypatch.setattr(WO, "rwkv6_scan_bwd_cuda", rwkv6_scan_bwd_ref)
    rng = np.random.RandomState(4)
    B, S, H, D = 2, 45, 3, 8
    base = [torch.tensor(rng.randn(B, S, H, D) * 0.5) for _ in range(3)] + [
        torch.tensor(-np.exp(rng.randn(B, S, H, D) * 0.5)),
        torch.tensor(rng.randn(H, D) * 0.3),
        torch.tensor(rng.randn(B, H, D, D) * 0.5)]
    dy = torch.tensor(rng.randn(B, S, H, D))
    grads = []
    for fn in ("function", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in base]
        if fn == "function":
            r, k, v, lw = (t.transpose(1, 2) for t in leaves[:4])
            y, _ = WO.WKV6ScanFn.apply(r, k, v, lw, leaves[4], leaves[5])
            y = y.transpose(1, 2)
        else:
            y, _ = WO.wkv_kernel_adapter("torch")(*leaves)
        grads.append(torch.autograd.grad((y * dy).sum(), leaves))
    for g, w in zip(*grads):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= ALGEBRA_TOL * max(
            1.0, float(w.abs().max()))


# ---- bf16: the mirror and the Function's plumbing ---------------------------
# The bf16 backward kernel widens bf16 x, B, C (and a bf16 dt) to fp32,
# walks as the fp32 kernel does and rounds each gradient once to its
# input's dtype; the per-head dB and dC are summed over a group in fp32
# before their one rounding.  Its mirror does the same on the CPU: held
# to float64 autograd on the same bf16 values within one bf16 ulp plus
# the fp32 mirror's LONG_TOL (fp32 outputs, dA and dh0, within LONG_TOL).

def _within_ulp(names, got, want, dtypes, tol):
    from repro_torch.kernels.flash_attention.ref import bf16_ulp
    for name, g, w, dt in zip(names, got, want, dtypes):
        if w is None:
            continue
        assert g.dtype == dt, (name, g.dtype, dt)
        err = (g.double() - w).abs()
        if dt == torch.bfloat16:
            err = err - bf16_ulp(w)
        bound = tol * max(1.0, float(w.abs().max()))
        assert float(err.max()) <= bound, (name, float(err.max()), bound)


@pytest.mark.parametrize("S,P,N,dt_bf16,h0,dhf", [
    (150, 8, 4, False, True, True), (70, 32, 16, True, False, True),
    (64, 4, 4, False, False, False)])
def test_ssd_mirror_in_bf16_matches_float64(S, P, N, dt_bf16, h0, dhf):
    bf16 = torch.bfloat16
    x, dt, A, Bm, Cm, hh, dy, dh = _ssd_inputs(2, 2, S, P, N, seed=S + N,
                                               h0=h0, dhf=dhf)
    args = [_t(x, bf16), _t(dt, bf16 if dt_bf16 else torch.float32),
            _t(A, torch.float32), _t(Bm, bf16), _t(Cm, bf16),
            _t(hh, torch.float32)]
    dy, dh = _t(dy, torch.float32), _t(dh, torch.float32)
    want = _autograd(ssm_scan_ref, [None if a is None else a.double()
                                    for a in args], dy.double(),
                     None if dh is None else dh.double())
    got = ssm_scan_bwd_ref(*args, dy, dh)
    if hh is None:
        got = list(got[:5]) + [None]
    _within_ulp(SSD_NAMES, got, want,
                [None if a is None else a.dtype for a in args], LONG_TOL)


def test_ssd_group_partials_are_summed_before_their_rounding():
    """``kernel.sum_partials``: the per-head fp32 dB of a group summed in
    fp32, then rounded once.  Planted partials 1 + 3·2⁻¹⁰ and 3·2⁻¹⁰: their
    fp32 sum rounds to 1 + 2⁻⁷ in bf16, each rounded first (to 1 and
    3·2⁻¹⁰) sums to 1.00293 and rounds to 1."""
    from repro_torch.kernels.ssm_scan.kernel import sum_partials
    B, S, G, rep, N = 2, 3, 2, 2, 4
    heads = torch.zeros((B, S, G * rep, N))        # the kernel's layout
    heads[..., 0::2, :] = 1 + 3 * 2.0 ** -10
    heads[..., 1::2, :] = 3 * 2.0 ** -10
    per_head = heads.transpose(1, 2)               # (B, H, S, N) view
    got = sum_partials(per_head, G, torch.bfloat16)
    assert got.shape == (B, G, S, N) and got.dtype == torch.bfloat16
    assert bool((got == 1 + 2.0 ** -7).all())
    each = per_head.to(torch.bfloat16).float()
    assert bool((each[:, 0::2] + each[:, 1::2]).to(torch.bfloat16).eq(
        1.0).all())
    # one head a group: the fp32 partial rounded as it is
    assert torch.equal(sum_partials(per_head, G * rep, torch.bfloat16),
                       per_head.to(torch.bfloat16))


def test_ssd_function_plumbing_in_bf16(monkeypatch):
    """``SSDScanFn`` on bf16 x, B and C (views of one projection) and an
    fp32 dt, the launches replaced by CPU stand-ins with the kernels'
    contracts (fp32 y; dx in x's dtype, per-head fp32 dB and dC summed by
    ``sum_partials``): each gradient in its input's dtype and equal to the
    mirror's, G 2 with H 4."""
    from repro_torch.kernels.ssm_scan.kernel import sum_partials
    calls = []

    def fwd(x, dt, A, Bm, Cm, h0=None):
        rep = x.shape[1] // Bm.shape[1]
        return ssm_scan_ref(x, dt, A, Bm.repeat_interleave(rep, 1),
                            Cm.repeat_interleave(rep, 1), h0)

    def bwd(x, dt, A, Bm, Cm, h0, dy, dhf):
        calls.append((x.dtype, Bm.dtype, dy.dtype))
        G = Bm.shape[1]
        rep = x.shape[1] // G
        out = ssm_scan_bwd_ref(x, dt, A,
                               Bm.float().repeat_interleave(rep, 1),
                               Cm.float().repeat_interleave(rep, 1), h0,
                               dy, dhf)
        dB, dC = (sum_partials(t, G, Bm.dtype) for t in out[3:5])
        return out[0], out[1], out[2], dB, dC, None
    monkeypatch.setattr(SO, "ssm_scan_cuda", fwd)
    monkeypatch.setattr(SO, "ssm_scan_bwd_cuda", bwd)
    rng = np.random.RandomState(6)
    B, S, H, P, N, G = 2, 70, 4, 8, 4, 2
    xbc = torch.tensor(rng.randn(B, S, H * P + 2 * G * N) * 0.5,
                       dtype=torch.bfloat16)
    dtv = torch.tensor(np.log1p(np.exp(rng.randn(B, S, H))),
                       dtype=torch.float32)
    A = torch.tensor(-np.exp(rng.rand(H)), dtype=torch.float32)
    dy = torch.tensor(rng.randn(B, S, H, P), dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (xbc, dtv, A)]
    x, Bm, Cm = torch.split(leaves[0], [H * P, G * N, G * N], -1)
    x, Bm, Cm = (x.reshape(B, S, H, P), Bm.reshape(B, S, G, N),
                 Cm.reshape(B, S, G, N))
    y, _ = SO.SSDScanFn.apply(x.transpose(1, 2), leaves[1].transpose(1, 2),
                              leaves[2], Bm.transpose(1, 2),
                              Cm.transpose(1, 2), None)
    assert y.dtype == torch.float32
    got = torch.autograd.grad((y.transpose(1, 2) * dy).sum(), leaves)
    assert calls == [(torch.bfloat16, torch.bfloat16, torch.float32)]
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    # the same gradients from the mirror, in the kernel layout
    xk, Bk, Ck = (t.detach().transpose(1, 2) for t in (x, Bm, Cm))
    dx, ddt, dA, dB, dC, _ = bwd(xk, dtv.transpose(1, 2), A, Bk, Ck, None,
                                 dy.transpose(1, 2), None)
    want = torch.cat([dx.transpose(1, 2).reshape(B, S, H * P),
                      dB.transpose(1, 2).reshape(B, S, G * N),
                      dC.transpose(1, 2).reshape(B, S, G * N)], -1)
    assert torch.equal(got[0], want)
    assert torch.equal(got[1], ddt.transpose(1, 2))
    assert torch.equal(got[2], dA)


# ---- the tensor-core backward's rounding points, mirrored in float64 --------
# ssd_bwd_mma (csrc/ssm_scan_bwd_mma.cu) passes each fp32 factor of its
# chunk products to the tensor cores as bf16 terms.  ref.ssm_scan_bwd_mma_
# mirror rounds them where the kernel does and runs the rest in float64;
# held here to float64 autograd on the same bf16 values under the card's
# gate (ref.bf16_grad_gate at SSM_BWD_TOL, 2e-4, and 1e-3 of own max |g|):
# the kernel's terms (ref.MMA_TERMS, two for every factor) pass at each
# shape, one term fewer for any single factor fails at one of them at
# least, and without rounding the mirror is ssm_scan_bwd_ref's algebra.

SSD_BWD_TOL = 2e-4
# (B, H, S, P, N, G, h0, dh_f, bf16 dt)
MMA_MIRROR_SHAPES = [
    (1, 2, 128, 64, 64, 1, False, False, False),
    (2, 4, 130, 32, 16, 2, True, True, True),
    (1, 4, 77, 64, 16, 4, False, False, False),
    (2, 2, 1, 32, 64, 1, True, True, False),
]


def _mma_case(B, H, S, P, N, G, h0, dhf, dt_bf16):
    """bf16 x, B and C (B and C per group), fp32 or bf16 dt, fp32 A, h0,
    dy and dh_f; and float64 autograd through the per-step oracle on the
    same values."""
    bf16 = torch.bfloat16
    rng = np.random.RandomState(S + N + H)
    x = torch.tensor(rng.randn(B, H, S, P) * 0.5).to(bf16)
    dt = torch.tensor(np.log1p(np.exp(rng.randn(B, H, S)))).to(
        bf16 if dt_bf16 else torch.float32)
    A = torch.tensor(-np.exp(rng.rand(H) * 2.8), dtype=torch.float32)
    Bm, Cm = (torch.tensor(rng.randn(B, G, S, N) * 0.5).to(bf16)
              for _ in range(2))
    hh = torch.tensor(rng.randn(B, H, P, N), dtype=torch.float32) \
        if h0 else None
    dy = torch.tensor(rng.randn(B, H, S, P), dtype=torch.float32)
    dh = torch.tensor(rng.randn(B, H, P, N), dtype=torch.float32) \
        if dhf else None
    args = [x, dt, A, Bm, Cm, hh]
    rep = H // G

    def plain(x, dt, A, Bm, Cm, h0):
        return ssm_scan_ref(x, dt, A, Bm.repeat_interleave(rep, 1),
                            Cm.repeat_interleave(rep, 1), h0)
    want = _autograd(plain, [None if a is None else a.double()
                             for a in args], dy.double(),
                     None if dh is None else dh.double())
    return args, dy, dh, want


def _mma_gate(got, want):
    """The names of the gradients that fail ``bf16_grad_gate``."""
    from repro_torch.kernels.flash_attention.ref import bf16_grad_gate
    return [name for name, g, w in zip(SSD_NAMES, got, want)
            if w is not None and not bf16_grad_gate(g, w, SSD_BWD_TOL)[2]]


@pytest.mark.parametrize("shape", MMA_MIRROR_SHAPES)
def test_ssd_mma_mirror_in_the_kernels_terms_passes_the_gate(shape):
    from repro_torch.kernels.ssm_scan.ref import (MMA_TERMS,
                                                  ssm_scan_bwd_mma_mirror)
    args, dy, dh, want = _mma_case(*shape)
    got = ssm_scan_bwd_mma_mirror(*args, dy, dh, terms=MMA_TERMS)
    for g, a in zip(got, args):
        assert a is None or g.dtype == a.dtype
    assert _mma_gate(got, want) == []


@pytest.mark.parametrize("factor", ["dy", "m", "q", "gc", "hs", "edy",
                                    "bstate"])
def test_ssd_mma_mirror_with_a_factor_in_one_term_fails_the_gate(factor):
    from repro_torch.kernels.ssm_scan.ref import (MMA_TERMS,
                                                  ssm_scan_bwd_mma_mirror)
    terms = dict(MMA_TERMS, **{factor: MMA_TERMS[factor] - 1})
    failed = {}
    for shape in MMA_MIRROR_SHAPES:
        args, dy, dh, want = _mma_case(*shape)
        failed[shape] = _mma_gate(ssm_scan_bwd_mma_mirror(
            *args, dy, dh, terms=terms), want)
    assert any(failed.values()), failed


@pytest.mark.parametrize("shape", MMA_MIRROR_SHAPES)
def test_ssd_mma_mirror_unrounded_is_the_reference(shape):
    """terms=None on float64 inputs: the kernel's orientation, its λ
    without the two cancelling terms and its group sums are
    ``ssm_scan_bwd_ref``'s algebra, within 1e-10 of max(1, max |g|)."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_mma_mirror
    B, H, S, P, N, G = shape[:6]
    args, dy, dh, _ = _mma_case(*shape)
    args = [None if a is None else a.double() for a in args]
    dy, dh = dy.double(), None if dh is None else dh.double()
    got = ssm_scan_bwd_mma_mirror(*args, dy, dh, terms=None)
    rep = H // G
    x, dt, A, Bm, Cm, hh = args
    want = list(ssm_scan_bwd_ref(x, dt, A, Bm.repeat_interleave(rep, 1),
                                 Cm.repeat_interleave(rep, 1), hh, dy, dh))
    want[3], want[4] = (t.reshape(B, G, rep, S, N).sum(2)
                        for t in want[3:5])
    if hh is None:
        got, want = got[:5], want[:5]
    _assert_close(got, want, ALGEBRA_TOL, SSD_NAMES)
