"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and the CUDA toolkit (the kernels are
built by ``nvcc`` at first use); elsewhere each one skips from the
``cuda`` fixture.  They import no JAX: the machine with the card has none.
Run them there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import caching as C
from repro_torch.core import round as R
from repro_torch.kernels.fed_agg import kernel as K
from repro_torch.kernels.fed_agg.ops import fed_agg_packed
from repro_torch.kernels.fed_agg.ref import fed_agg_ref
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention.ref import (BF16_FLOOR,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     bf16_excess)
from repro_torch.kernels.robust_agg import kernel as RK
from repro_torch.kernels.robust_agg import ops as RO
from repro_torch.kernels.robust_agg.ref import (geometric_median_torch,
                                                residual_norms_ref)

pytestmark = pytest.mark.gpu

# fp32, other summation order than the plain version: the error of each
# output is held to 1e-5 of Σ_c |w_c · u_cd|, the scale its rounding
# errors grow with
REL_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(C, D, seed, device, zero_frac=0.0):
    rng = np.random.RandomState(seed)
    u = rng.randn(C, D).astype(np.float32)
    w = rng.rand(C).astype(np.float32)
    w[rng.rand(C) < zero_frac] = 0.0
    w /= max(w.sum(), 1e-30)
    return (torch.from_numpy(u).to(device), torch.from_numpy(w).to(device))


def _check(got, u, w):
    want = fed_agg_ref(u, w)
    scale = fed_agg_ref(u.abs(), w.abs())
    err = (got - want).abs()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert bool((err <= REL_TOL * scale + 1e-30).all()), \
        float((err / scale.clamp_min(1e-30)).max())


@pytest.mark.parametrize("C,D", [(4096, 22026), (13, 22026), (4096, 1),
                                 (13, 2049), (1, 5), (517, 300),
                                 # D mod 4 = 0, 1, 2, 3; C off the chunks
                                 (4093, 22024), (4093, 22025), (999, 22026),
                                 (4095, 22027), (3, 2)])
def test_fed_agg_kernel_matches_plain(cuda, C, D):
    u, w = _inputs(C, D, seed=C + D, device=cuda, zero_frac=0.5)
    got = fed_agg_packed(u, w, impl="cuda")
    torch.cuda.synchronize()
    _check(got, u, w)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("D", [22026, 22025])
def test_fed_agg_kernel_reads_misaligned_rows(cuda, offset, D):
    """A buffer that starts 4, 8 or 12 bytes past a 16-byte boundary."""
    u, w = _inputs(777, D, seed=offset, device=cuda)
    flat = torch.empty(777 * D + offset, device=cuda)
    flat[offset:] = u.reshape(-1)
    shifted = flat[offset:].view(777, D)
    assert shifted.data_ptr() % 16 == 4 * offset
    got = fed_agg_packed(shifted, w, impl="cuda")
    torch.cuda.synchronize()
    _check(got, u, w)


def test_fed_agg_kernel_propagates_nan_from_zero_weight_rows(cuda):
    """A zero-weight row is read like any other: 0 * NaN is NaN, as in
    the plain version."""
    u, w = _inputs(300, 22026, seed=9, device=cuda)
    w[17] = 0.0
    u[17, 5:9] = float("nan")
    got = fed_agg_packed(u, w, impl="cuda")
    want = fed_agg_ref(u, w)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert int(torch.isnan(got).sum()) == 4
    keep = ~torch.isnan(want)
    _check(got[keep], u[:, keep], w)


@pytest.mark.parametrize("block_c,block_d", [(1, 256), (8, 512), (3, 1024),
                                             (64, 2048)])
def test_fed_agg_kernel_tile_knobs(cuda, block_c, block_d):
    u, w = _inputs(1000, 5000, seed=7, device=cuda)
    got = fed_agg_packed(u, w, impl="cuda", block_c=block_c,
                         block_d=block_d)
    torch.cuda.synchronize()
    _check(got, u, w)


def test_fed_agg_kernel_zero_weights_give_zeros(cuda):
    u, _ = _inputs(4096, 2049, seed=1, device=cuda)
    w = torch.zeros(4096, device=cuda)
    got = fed_agg_packed(u, w, impl="cuda")
    assert bool((got == 0).all())


def test_fed_agg_kernel_is_deterministic(cuda):
    u, w = _inputs(4096, 22026, seed=2, device=cuda)
    a = fed_agg_packed(u, w, impl="cuda")
    b = fed_agg_packed(u, w, impl="cuda")
    assert torch.equal(a, b)


def test_fed_agg_kernel_counts_each_launch(cuda):
    u, w = _inputs(8, 300, seed=3, device=cuda)
    before = K.launches.count
    fed_agg_packed(u, w, impl="cuda")
    fed_agg_packed(u, w, impl="torch")          # plain version: no launch
    assert K.launches.count == before + 1


def test_fed_agg_kernel_rejects_what_it_does_not_take(cuda):
    u, w = _inputs(8, 300, seed=4, device=cuda)
    with pytest.raises(TypeError):
        fed_agg_packed(u.to(torch.bfloat16), w, impl="cuda")
    with pytest.raises(ValueError):                 # not contiguous
        fed_agg_packed(u.t(), torch.ones(300, device=cuda), impl="cuda")
    with pytest.raises(ValueError):
        fed_agg_packed(u, w[:4], impl="cuda")
    with pytest.raises(ValueError):
        fed_agg_packed(u, w.cpu(), impl="cuda")
    with pytest.raises(ValueError):
        fed_agg_packed(u, w, impl="cuda", block_d=100)


# ---------------------------------------------------------------------------
# residual_norms
# ---------------------------------------------------------------------------

def _rows(C, D, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.randn((C, D), generator=gen, device=device)
    z = torch.randn((D,), generator=gen, device=device)
    return u, z


@pytest.mark.parametrize("C,D", [(4096, 22026), (13, 22026), (4096, 1),
                                 (1, 5), (517, 300), (3, 1023)])
def test_residual_norms_kernel_matches_plain(cuda, C, D):
    u, z = _rows(C, D, seed=C + D, device=cuda)
    got = RO.residual_norms(u, z, impl="cuda")
    torch.cuda.synchronize()
    want = residual_norms_ref(u, z)
    assert got.shape == (C,) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=REL_TOL, atol=0)


def test_residual_norms_kernel_at_the_center_is_zero(cuda):
    u, _ = _rows(64, 22026, seed=5, device=cuda)
    got = RO.residual_norms(u, u[7].contiguous(), impl="cuda")
    assert got[7].item() == 0.0
    torch.testing.assert_close(got, residual_norms_ref(u, u[7]),
                               rtol=REL_TOL, atol=0)


def test_residual_norms_kernel_is_deterministic(cuda):
    u, z = _rows(4096, 22026, seed=6, device=cuda)
    assert torch.equal(RO.residual_norms(u, z, impl="cuda"),
                       RO.residual_norms(u, z, impl="cuda"))


def test_residual_norms_kernel_counts_each_launch(cuda):
    u, z = _rows(8, 300, seed=3, device=cuda)
    before = RK.launches.count
    RO.residual_norms(u, z, impl="cuda")
    RO.residual_norms(u, z, impl="torch")          # plain version
    RO.residual_norms(u[:0], z, impl="cuda")        # empty: no launch
    assert RK.launches.count == before + 1


def test_residual_norms_kernel_rejects_what_it_does_not_take(cuda):
    u, z = _rows(8, 300, seed=4, device=cuda)
    with pytest.raises(TypeError):
        RO.residual_norms(u.double(), z.double(), impl="cuda")
    with pytest.raises(ValueError):                 # not contiguous
        RO.residual_norms(u.t(), torch.ones(8, device=cuda), impl="cuda")
    with pytest.raises(ValueError):
        RO.residual_norms(u, z[:4], impl="cuda")
    with pytest.raises(ValueError):
        RO.residual_norms(u, z.cpu(), impl="cuda")


def test_geometric_median_on_the_card_matches_plain(cuda):
    u, _ = _rows(4096, 2000, seed=8, device=cuda)
    w = torch.rand(4096, device=cuda)
    w[torch.rand(4096, device=cuda) < 0.9] = 0.0
    got = RO.geometric_median(u, w, impl="cuda")
    torch.testing.assert_close(got, geometric_median_torch(u, w),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rule,norms,sums", [
    ("mean", 0, 1), ("geometric_median", 6, 7), ("trimmed_mean", 0, 0),
    ("trust", 1, 1)])
def test_server_step_launches_per_round(cuda, rule, norms, sums):
    template = {"a": {"w": torch.ones(30, 20, device=cuda),
                      "b": torch.zeros(20, device=cuda)}}
    step = R.make_server_round_step(template, local_steps=2,
                                    agg_rule=rule, adversary_scale=-4.0)
    n = 64
    final = {"a": {"w": torch.randn(n, 30, 20, device=cuda),
                   "b": torch.randn(n, 20, device=cuda)}}
    mask = torch.rand(n, device=cuda) < 0.5
    extra = (mask,) + ((torch.ones(n, device=cuda),)
                       if rule == "trust" else ())
    ones = torch.ones(n, device=cuda)
    before = (RK.launches.count, K.launches.count)
    step(template, C.init_caches(template, n), final, final,
         torch.zeros(n, dtype=torch.int32, device=cuda), mask, ~mask, mask,
         torch.zeros(n, dtype=torch.bool, device=cuda), ones, ones, 0,
         *extra)
    assert (RK.launches.count - before[0], K.launches.count - before[1]) \
        == (norms, sums)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

# fp32 (the SIMT variant): both sides compute in fp32 and differ in
# summation order only, within 1e-5 of max(1, |o|).  bf16 (the wgmma
# variant) carries P in two bf16 terms and rounds its output once: each
# element within one bf16 ulp of the fp32 truth (attention_ref on the same
# bf16 inputs, fp32 P and output) plus ref.BF16_FLOOR (2^-12) of its
# row's largest |truth|, the gate of chip_smoke.py
FLASH_F32_TOL = 1e-5


def _qkv(B, Hq, Hkv, Sq, Sk, D, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device).to(dtype)
                 for shape in ((B, Hq, Sq, D), (B, Hkv, Sk, D),
                               (B, Hkv, Sk, D)))


def _check_flash(got, q, k, v, **kw):
    """``got`` against the plain version on the same inputs: the fp32
    tolerance, or the bf16 gate above."""
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    if got.dtype == torch.float32:
        want = attention_ref(q, k, v, **kw)
        err = (got - want).abs()
        assert bool((err <= FLASH_F32_TOL * torch.maximum(
            got.abs(), want.abs()).clamp_min(1.0)).all()), float(err.max())
        return
    truth = attention_ref(q.float(), k.float(), v.float(), **kw)
    excess = bf16_excess(got, truth)
    assert excess <= BF16_FLOOR, excess


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,dtype,q_offset,causal,window", [
    (2, 28, 4, 256, 256, 128, torch.bfloat16, 0, True, None),
    (1, 32, 8, 300, 300, 80, torch.bfloat16, 0, True, 128),
    (1, 3, 3, 100, 100, 64, torch.float32, 0, True, None),
    (2, 14, 2, 70, 107, 64, torch.float32, 37, True, None),
    (1, 7, 1, 130, 190, 64, torch.float32, 60, True, 50),
    (1, 4, 2, 65, 64, 80, torch.float32, 50, False, 20),
    (1, 4, 4, 1, 77, 128, torch.float32, 76, True, None),
    (2, 8, 4, 100, 100, 32, torch.float32, 0, True, None),
    (2, 8, 4, 64, 64, 32, torch.bfloat16, 0, True, None),
    (1, 6, 2, 150, 150, 192, torch.float32, 0, True, 64),
    (1, 96, 8, 130, 130, 192, torch.bfloat16, 0, True, None),
    # bf16 at every head dim: ragged Sq and Sk, q_offset with Sq < Sk,
    # windows, one query, and rows that see no key
    (2, 8, 4, 100, 100, 32, torch.bfloat16, 0, True, 40),
    (1, 8, 8, 4096, 4096, 64, torch.bfloat16, 0, True, None),
    (2, 14, 2, 70, 300, 64, torch.bfloat16, 230, True, None),
    (1, 4, 2, 200, 200, 64, torch.bfloat16, 50, False, 20),
    (1, 8, 2, 777, 777, 80, torch.bfloat16, 0, True, 300),
    (1, 4, 4, 1, 77, 128, torch.bfloat16, 76, True, None),
    (1, 7, 1, 333, 1000, 128, torch.bfloat16, 667, True, 100),
    (1, 4, 2, 130, 256, 128, torch.bfloat16, 0, False, None),
    (1, 6, 2, 150, 150, 192, torch.bfloat16, 0, True, 64),
])
def test_flash_kernel_matches_plain(cuda, B, Hq, Hkv, Sq, Sk, D, dtype,
                                    q_offset, causal, window):
    """Every variant of the dtype against the plain version: bf16's
    wgmma; fp32's wgmma_f32 (the default) and simt (by name), each with
    its lse against the plain one within 1e-5 of max(1, |lse|)."""
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, D, dtype, cuda, seed=Sq + Sk)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    for variant in FK.FWD_ALLOWED[dtype]:
        before = dict(FK.launches_by_variant)
        got, lse = FK.flash_attention_cuda(q, k, v, variant=variant,
                                           with_lse=True, **kw)
        torch.cuda.synchronize()
        assert {n: c - before[n] for n, c in FK.launches_by_variant.items()
                if c != before[n]} == {variant: 1}
        _check_flash(got, q, k, v, **kw)
        if dtype == torch.float32:
            want = attention_lse_ref(q, k, **kw)
            assert bool(((lse - want).abs()
                         <= 1e-5 * want.abs().clamp_min(1.0)).all())


def test_flash_bf16_rows_without_a_visible_key_average_v(cuda):
    """Non-causal with a window, past the keys, in a 128-row query tile:
    row i (position 200 + i) sees keys 171 + i .. 199 (window 30), so rows
    from 29 on see none and average V over every key."""
    q, k, v = _qkv(1, 4, 2, 160, 200, 64, torch.bfloat16, cuda, seed=3)
    kw = dict(causal=False, window=30, q_offset=200)
    got = FK.flash_attention_cuda(q, k, v, **kw)
    _check_flash(got, q, k, v, **kw)
    mean_v = v.float().mean(2).repeat_interleave(2, dim=1)[:, :, None]
    torch.testing.assert_close(got[:, :, 29:].float(),
                               mean_v.expand(-1, -1, 131, -1),
                               rtol=2 ** -7, atol=2 ** -7)


def test_flash_fp32_reads_model_layout_views_in_place(cuda):
    """The fp32 training path's call: (B, S, Hk, G, D) and (B, S, Hk, D)
    fp32 projections, strided (B, H, S, D) views, through the tensor-core
    variant (its split pre-pass reads the views, TMA the term planes) and
    its lse, at 100m's heads (group 3, D 64) with a ragged S."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((3, 200, 4, 3, 64), (3, 200, 4, 64),
                             (3, 200, 4, 64)))
    B, S, Hk, G, D = q.shape
    qh = q.reshape(B, S, Hk * G, D).transpose(1, 2)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    assert not qh.is_contiguous() and not kh.is_contiguous()
    before = dict(FK.launches_by_variant)
    got, lse = FK.flash_attention_cuda(qh, kh, vh, causal=True,
                                       with_lse=True)
    assert FK.launches_by_variant["wgmma_f32"] == before["wgmma_f32"] + 1
    assert got.stride() == qh.stride()
    _check_flash(got, qh, kh, vh, causal=True)
    want = attention_lse_ref(qh, kh, causal=True)
    assert bool(((lse - want).abs() <= 1e-5 * want.abs().clamp_min(1.0))
                .all())
    again = FO.flash_attention_model_layout(q, k, v, causal=True)
    assert torch.equal(again, got.transpose(1, 2).reshape(q.shape))


def test_flash_kernel_reads_model_layout_views_in_place(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, 90, 2, 3, 64), generator=gen, device=cuda)
    k = torch.randn((2, 90, 2, 64), generator=gen, device=cuda)
    v = torch.randn((2, 90, 2, 64), generator=gen, device=cuda)
    got = FO.flash_attention_model_layout(q, k, v, causal=True, window=30)
    want = FO.flash_attention_model_layout(q, k, v, causal=True, window=30,
                                           impl="torch")
    assert got.is_contiguous()
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got - want).abs()
    assert bool((err <= FLASH_F32_TOL * torch.maximum(
        got.abs(), want.abs()).clamp_min(1.0)).all()), float(err.max())


def test_flash_bf16_reads_model_layout_views_in_place(cuda):
    """The serve path's call: (B, S, Hk, G, D) and (B, S, Hk, D) bf16
    projections read through TMA maps over their strided views."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               .to(torch.bfloat16)
               for shape in ((2, 300, 2, 7, 128), (2, 300, 2, 128),
                             (2, 300, 2, 128)))
    before = dict(FK.launches_by_variant)
    got = FO.flash_attention_model_layout(q, k, v, causal=True)
    assert FK.launches_by_variant["wgmma"] == before["wgmma"] + 1
    B, S, Hk, G, D = q.shape
    _check_flash(got.reshape(B, S, Hk * G, D).transpose(1, 2),
                 q.reshape(B, S, Hk * G, D).transpose(1, 2),
                 k.transpose(1, 2), v.transpose(1, 2), causal=True)


def test_flash_kernel_is_deterministic(cuda):
    q, k, v = _qkv(2, 8, 2, 500, 500, 128, torch.bfloat16, cuda)
    assert torch.equal(FK.flash_attention_cuda(q, k, v),
                       FK.flash_attention_cuda(q, k, v))
    q, k, v = (x.float() for x in (q, k, v))
    for variant in ("wgmma_f32", "simt"):
        a = FK.flash_attention_cuda(q, k, v, variant=variant, with_lse=True)
        b = FK.flash_attention_cuda(q, k, v, variant=variant, with_lse=True)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_kernel_counts_each_launch(cuda):
    q, k, v = _qkv(1, 2, 2, 16, 16, 64, torch.float32, cuda)
    before = FK.launches.count
    FO.flash_attention(q, k, v)
    FO.flash_attention(q, k, v, impl="torch")      # plain version
    FO.flash_attention(q, k[:, :, :0], v[:, :, :0])   # no keys: no launch
    assert FK.launches.count == before + 1


def test_flash_bf16_goes_to_wgmma_and_fp32_to_simt(cuda):
    before = dict(FK.launches_by_variant)
    total = FK.launches.count
    for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
        FO.flash_attention(*_qkv(1, 4, 2, 70, 70, 64, dtype, cuda))
    FK.flash_attention_cuda(*_qkv(1, 4, 2, 70, 70, 64, torch.float32,
                                  cuda), variant="simt")
    assert FK.launches_by_variant == {
        "wgmma": before["wgmma"] + 2, "wgmma_f32": before["wgmma_f32"] + 1,
        "simt": before["simt"] + 1}
    assert FK.launches.count == total + 4
    with pytest.raises(ValueError, match="variant"):
        FK.flash_attention_cuda(*_qkv(1, 4, 2, 70, 70, 64, torch.bfloat16,
                                      cuda), variant="simt")


def test_flash_bf16_refuses_what_tma_cannot_read(cuda):
    q, k, v = _qkv(1, 4, 2, 64, 64, 64, torch.bfloat16, cuda)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):    # base off by 2 B
        FK.flash_attention_cuda(flat[1:].view(q.shape), k, v)
    wide = torch.zeros((1, 2, 64, 68), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):   # 136 B rows
        FK.flash_attention_cuda(q, wide[..., :64], v)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 4, 2, 16, 16, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        FK.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):                  # no head_dim 96 variant
        FK.flash_attention_cuda(*_qkv(1, 2, 2, 8, 8, 96, torch.float32,
                                      cuda))
    with pytest.raises(ValueError):                  # last axis strided
        FK.flash_attention_cuda(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        FK.flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError):                  # Hq not a multiple
        FK.flash_attention_cuda(q[:, :3], k, v)


@pytest.mark.parametrize("arch", ["qwen2-7b", "h2o-danube-1.8b",
                                  "zamba2-1.2b"])
def test_bf16_prefill_launches_only_the_wgmma_variant(cuda, arch):
    """A bf16 prefill of each dense and hybrid model: every attention
    through flash_fwd_wgmma, none through the SIMT variant, and no
    launch in a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import _hybrid_segments
    cfg = get_config(arch).reduced(param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    model = build_model(cfg)
    n = len(_hybrid_segments(cfg)) if cfg.hybrid is not None \
        else cfg.num_layers
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, 512, (2, 140), device=cuda)
    before = dict(FK.launches_by_variant)
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": tokens}, max_len=145)
        pos = torch.full((2, 1), 140, dtype=torch.int32, device=cuda)
        model.decode_step(params, tokens[:, :1], pos, cache)
    assert FK.launches_by_variant == {"wgmma": before["wgmma"] + n,
                                      "wgmma_f32": before["wgmma_f32"],
                                      "simt": before["simt"]}


def test_prefill_launches_flash_once_per_layer_and_decode_never(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    for arch in ("qwen2-7b", "h2o-danube-1.8b"):
        model = build_model(get_config(arch).reduced())
        params = model.init(torch.Generator(device=cuda).manual_seed(0))
        tokens = torch.randint(0, 512, (2, 40), device=cuda)
        before = FK.launches.count
        with torch.inference_mode():
            _, cache = model.prefill(params, {"tokens": tokens}, max_len=45)
            assert FK.launches.count == before + model.cfg.num_layers
            pos = torch.full((2, 1), 40, dtype=torch.int32, device=cuda)
            model.decode_step(params, tokens[:, :1], pos, cache)
        assert FK.launches.count == before + model.cfg.num_layers


def test_serve_default_arch_runs_through_the_kernel(cuda, capsys):
    """``python -m repro_torch.launch.serve`` with no flags: flude-paper,
    head_dim 32, on the card, one flash launch per layer."""
    from repro_torch.launch import serve as S
    before = FK.launches.count
    res = S.main(["--decode-tokens", "3"])
    assert FK.launches.count == before + 4          # flude-paper's layers
    assert res.ids.shape == (4, 4)
    assert capsys.readouterr().out.startswith("serving flude-paper: ")


def test_prefill_and_decode_do_not_synchronise(cuda):
    """No step of the serve path waits for the card: a hidden sync (a
    host copy, ``.item()``) serialises the host's dispatch with the
    device and made decode host-bound once already."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    model = build_model(get_config("h2o-danube-1.8b").reduced())
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, 512, (2, 40), device=cuda)
    pos = torch.full((2, 1), 40, dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": tokens}, max_len=45)
        model.decode_step(params, tokens[:, :1], pos, cache)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, cache = model.prefill(params, {"tokens": tokens}, max_len=45)
            model.decode_step(params, tokens[:, :1], pos, cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# ssm_scan and rwkv6_scan
# ---------------------------------------------------------------------------

# Both SSD variants compute the chunked form at chunk 64 (the bf16 one
# with its fp32 factors as two bf16 terms), the plain version the
# per-step recurrence: exp of a within-chunk cumsum against a product of
# per-step exps, 2.5e-5 of max(1, |y|) measured on the CPU at S 4096
# (P = N = 64); held to 2e-4.  The SIMT WKV kernel runs the plain
# version's own per-step recurrence in another summation order (1e-6 of
# max(1, |y|) between fp32 and fp64 on the CPU), the bf16 one the chunked
# form with fp32 operands as three bf16 terms; both held to 2e-5.
SSM_REL = 2e-4
WKV_REL = 2e-5


def _within(got, want, rel):
    err = (got - want).abs()
    return bool((err <= rel * want.abs().clamp_min(1.0)).all()), \
        float(err.max())


def _ssd_inputs(B, S, H, P, N, G, dtype, device, seed=0, h0=False):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = (rn(B, S, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H))
    A = -(torch.rand((H,), generator=gen, device=device) * 4 + 0.5)
    Bm = (rn(B, S, G, N) * 0.5).to(dtype)
    Cm = (rn(B, S, G, N) * 0.5).to(dtype)
    return x, dt, A, Bm, Cm, (rn(B, H, P, N) if h0 else None)


def _ssd_plain(x, dt, A, Bm, Cm, h0):
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    rep = x.shape[2] // Bm.shape[2]
    y, h = ssm_scan_ref(x.transpose(1, 2), dt.transpose(1, 2), A,
                        Bm.transpose(1, 2).repeat_interleave(rep, 1),
                        Cm.transpose(1, 2).repeat_interleave(rep, 1), h0)
    return y.transpose(1, 2), h


# the cases of chip_smoke.py's scan phases and more: S off the chunk, S 1,
# G 2 with H 4, P 32 / N 16, D 32, h0 / s0; each under both variants
SCAN_VARIANTS = pytest.mark.parametrize(
    "dtype", [torch.float32, torch.bfloat16], ids=["simt", "mma"])


@SCAN_VARIANTS
@pytest.mark.parametrize("B,S,H,P,N,G,h0", [
    (1, 100, 4, 32, 16, 2, False),                  # ragged, G 2
    (2, 64, 2, 64, 64, 1, True),
    (1, 130, 4, 64, 16, 4, True),
    (1, 77, 2, 32, 64, 1, False),
    (2, 1, 2, 64, 64, 1, True),                     # one step
    (1, 300, 8, 64, 64, 1, False),
    (2, 1000, 4, 32, 16, 2, False),                 # ragged S 1000
])
def test_ssm_scan_kernel_matches_plain(cuda, B, S, H, P, N, G, h0, dtype):
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    args = _ssd_inputs(B, S, H, P, N, G, dtype, cuda, seed=S, h0=h0)
    before = dict(SK.launches.by_variant)
    y, h = ssm_scan(*args, impl="cuda")
    torch.cuda.synchronize()
    variant = SK.VARIANTS[dtype]
    assert {v: n - before[v] for v, n in SK.launches.by_variant.items()} \
        == {v: int(v == variant) for v in before}
    want_y, want_h = _ssd_plain(*args)
    assert y.shape == (B, S, H, P) and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    for got, want in ((y, want_y), (h, want_h)):
        ok, err = _within(got, want, SSM_REL)
        assert ok, err


@SCAN_VARIANTS
def test_ssm_scan_kernel_splits_over_a_carried_state(cuda, dtype):
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    x, dt, A, Bm, Cm, _ = _ssd_inputs(2, 150, 4, 32, 16, 2, dtype, cuda,
                                      seed=3)
    y, h = ssm_scan(x, dt, A, Bm, Cm)
    y1, h1 = ssm_scan(x[:, :70], dt[:, :70], A, Bm[:, :70], Cm[:, :70])
    y2, h2 = ssm_scan(x[:, 70:], dt[:, 70:], A, Bm[:, 70:], Cm[:, 70:], h1)
    assert _within(torch.cat([y1, y2], 1), y, SSM_REL)[0]
    assert _within(h2, h, SSM_REL)[0]


@SCAN_VARIANTS
def test_ssm_scan_kernel_is_deterministic_and_counts_launches(cuda, dtype):
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    args = _ssd_inputs(2, 200, 4, 64, 64, 1, dtype, cuda)
    before = SK.launches.count
    by_variant = dict(SK.launches.by_variant)
    a = ssm_scan(*args)
    b = ssm_scan(*args)
    ssm_scan(*args, impl="torch")                   # plain version
    assert SK.launches.count == before + 2
    assert SK.launches.by_variant[SK.VARIANTS[dtype]] == \
        by_variant[SK.VARIANTS[dtype]] + 2
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_ssm_scan_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan_cuda
    x, dt, A, Bm, Cm, _ = _ssd_inputs(1, 8, 4, 32, 16, 2, torch.float32,
                                      cuda)
    k = lambda t: t.transpose(1, 2)                 # noqa: E731
    with pytest.raises(ValueError, match=r"\(32, 32\)"):   # no N 32 variant
        ssm_scan_cuda(k(x), k(dt), A, k(torch.cat([Bm, Bm], -1)),
                      k(torch.cat([Cm, Cm], -1)))
    with pytest.raises(TypeError):
        ssm_scan_cuda(k(x).half(), k(dt), A, k(Bm).half(), k(Cm).half())
    with pytest.raises(ValueError):                 # H not a multiple of G
        ssm_scan_cuda(k(x[:, :, :3]), k(dt[:, :, :3]), A[:3], k(Bm), k(Cm))
    with pytest.raises(ValueError):
        ssm_scan_cuda(k(x), k(dt), A.cpu(), k(Bm), k(Cm))
    # bf16 rows the mma variant cannot copy 16 bytes at a time
    flat = torch.zeros(1 + x.numel(), dtype=torch.bfloat16, device=cuda)
    xs = flat[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ssm_scan_cuda(k(xs), k(dt), A, k(Bm).bfloat16(), k(Cm).bfloat16())


def _wkv_inputs(B, S, H, D, dtype, device, seed=0, s0=False):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    r, k, v = ((rn(B, S, H, D) * 0.5).to(dtype) for _ in range(3))
    lw = -torch.exp(rn(B, S, H, D) * 0.5)
    u = rn(H, D) * 0.3
    return r, k, v, lw, u, (rn(B, H, D, D) * 0.5 if s0 else None)


@SCAN_VARIANTS
@pytest.mark.parametrize("B,S,H,D,s0", [
    (1, 100, 4, 32, True),                           # ragged, D 32, s0
    (2, 64, 2, 64, False),
    (1, 77, 3, 64, True),
    (2, 1, 2, 32, True),                             # one step
    (1, 333, 8, 64, False),
    (2, 1000, 8, 32, False),                         # ragged S 1000
])
def test_rwkv6_scan_kernel_matches_plain(cuda, B, S, H, D, s0, dtype):
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter
    args = _wkv_inputs(B, S, H, D, dtype, cuda, seed=S, s0=s0)
    before = dict(WK.launches.by_variant)
    y, s = wkv_kernel_adapter("cuda")(*args)
    torch.cuda.synchronize()
    variant = WK.VARIANTS[dtype]
    assert {v: n - before[v] for v, n in WK.launches.by_variant.items()} \
        == {v: int(v == variant) for v in before}
    want_y, want_s = wkv_kernel_adapter("torch")(*args)
    assert y.shape == (B, S, H, D) and y.dtype == torch.float32
    for got, want in ((y, want_y), (s, want_s)):
        ok, err = _within(got, want, WKV_REL)
        assert ok, err


@SCAN_VARIANTS
def test_rwkv6_scan_kernel_splits_over_a_carried_state(cuda, dtype):
    from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter
    kern = wkv_kernel_adapter("cuda")
    r, k, v, lw, u, s0 = _wkv_inputs(2, 300, 4, 64, dtype, cuda, seed=5,
                                     s0=True)
    y, s = kern(r, k, v, lw, u, s0)
    y1, s1 = kern(r[:, :45], k[:, :45], v[:, :45], lw[:, :45], u, s0)
    y2, s2 = kern(r[:, 45:], k[:, 45:], v[:, 45:], lw[:, 45:], u, s1)
    assert _within(torch.cat([y1, y2], 1), y, WKV_REL)[0]
    assert _within(s2, s, WKV_REL)[0]


@SCAN_VARIANTS
def test_rwkv6_scan_kernel_is_deterministic_and_counts_launches(cuda,
                                                                dtype):
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter
    args = _wkv_inputs(2, 150, 4, 64, dtype, cuda, s0=True)
    before = WK.launches.count
    by_variant = dict(WK.launches.by_variant)
    a = wkv_kernel_adapter()(*args)
    b = wkv_kernel_adapter()(*args)
    wkv_kernel_adapter("torch")(*args)              # plain version
    assert WK.launches.count == before + 2
    assert WK.launches.by_variant[WK.VARIANTS[dtype]] == \
        by_variant[WK.VARIANTS[dtype]] + 2
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_rwkv6_scan_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_cuda
    r, k, v, lw, u, _ = _wkv_inputs(1, 8, 2, 32, torch.float32, cuda)
    t = lambda a: a.transpose(1, 2)                 # noqa: E731
    with pytest.raises(ValueError, match="16"):     # no D 16 variant
        rwkv6_scan_cuda(t(r[..., :16]), t(k[..., :16]), t(v[..., :16]),
                        t(lw[..., :16]), u[:, :16])
    with pytest.raises(TypeError):
        rwkv6_scan_cuda(t(r).half(), t(k).half(), t(v).half(), t(lw), u)
    with pytest.raises(ValueError):
        rwkv6_scan_cuda(t(r), t(k), t(v), t(lw), u[:1])
    with pytest.raises(ValueError):
        rwkv6_scan_cuda(t(r), t(k), t(v).cpu(), t(lw), u)
    # bf16 rows the mma variant cannot copy 16 bytes at a time
    flat = torch.zeros(1 + r.numel(), dtype=torch.bfloat16, device=cuda)
    rs = flat[1:].view(r.shape)
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_scan_cuda(t(rs), t(k).bfloat16(), t(v).bfloat16(), t(lw), u)


def test_stateful_prefill_launches_the_scans_and_decode_never(cuda):
    """Reduced zamba2: one ssm_scan launch per Mamba2 layer and one
    flash launch per shared-attention application a prefill; reduced
    RWKV6: one rwkv6_scan launch per layer.  No launch in a decode
    step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.models import build_model
    from repro_torch.models.transformer import _hybrid_segments
    counters = {"ssm_scan": SK.launches, "rwkv6_scan": WK.launches,
                "flash_attention": FK.launches}
    for arch in ("zamba2-1.2b", "rwkv6-7b"):
        model = build_model(get_config(arch).reduced())
        cfg = model.cfg
        want = {"ssm_scan": 0, "rwkv6_scan": cfg.num_layers,
                "flash_attention": 0}
        if arch == "zamba2-1.2b":
            want = {"ssm_scan": cfg.num_layers, "rwkv6_scan": 0,
                    "flash_attention": len(_hybrid_segments(cfg))}
        params = model.init(torch.Generator(device=cuda).manual_seed(0))
        tokens = torch.randint(0, 512, (2, 70), device=cuda)
        before = {k: c.count for k, c in counters.items()}
        with torch.inference_mode():
            _, cache = model.prefill(params, {"tokens": tokens}, max_len=75)
            pos = torch.full((2, 1), 70, dtype=torch.int32, device=cuda)
            model.decode_step(params, tokens[:, :1], pos, cache)
        assert {k: c.count - before[k] for k, c in counters.items()} == \
            want, arch


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_stateful_prefill_and_decode_do_not_synchronise(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    model = build_model(get_config(arch).reduced())
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, 512, (2, 70), device=cuda)
    pos = torch.full((2, 1), 70, dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": tokens}, max_len=75)
        model.decode_step(params, tokens[:, :1], pos, cache)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, cache = model.prefill(params, {"tokens": tokens}, max_len=75)
            model.decode_step(params, tokens[:, :1], pos, cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# The device dynamics round loop
# ---------------------------------------------------------------------------

def _dyn_engine(device, dynamics="bernoulli", depth=1, n=64, rounds=4):
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import federated_classification
    from repro_torch.fl import FleetEngine, SimConfig
    from repro_torch.fleet import apply_scenario
    scenario = dynamics == "churn"
    fl = FLConfig(num_clients=n, clients_per_round=16, pipeline_depth=depth,
                  dynamics="bernoulli" if scenario else dynamics)
    if scenario:
        fl = apply_scenario(fl, dynamics)
    return FleetEngine(federated_classification(n, seed=1, n_per_client=32),
                       SimConfig(num_clients=n, rounds=rounds, seed=2,
                                 local_steps=2), fl, device=device)


def test_dynamics_loop_does_not_synchronise_outside_the_ledger(cuda):
    """A flude run on the device loop at depth 2 under sync debug mode
    "error": the only waits for the card are the round ledger's resolve
    and the run-end read-back, which lift the mode (``host_readback``)."""
    engine = _dyn_engine(cuda, depth=2)
    engine.run("flude")                      # builds, places, warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hist = engine.run("flude", diagnostics=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(hist.acc) == 4


def test_dynamics_loop_card_matches_cpu(cuda):
    """N = 24, 5 rounds under churn, the dynamics and explore uniforms
    drawn once on the CPU and handed to both runs: the same integer
    trajectory, wall clock within 1e-5, accuracy within 4 of 2048."""
    from repro_torch.fleet import draw_noise, get_dynamics
    proc = get_dynamics("markov")
    gen = torch.Generator().manual_seed(0)
    noise = {"init": draw_noise(proc.init_noise, 24, gen, "cpu")}
    for rnd in range(5):
        noise[rnd] = draw_noise(proc.step_noise, 24, gen, "cpu")
    us = [torch.rand(24, generator=gen) for _ in range(5)]
    runs = [_dyn_engine(d, "churn", n=24, rounds=5).run(
        "flude", explore_uniforms=lambda r: us[r],
        dynamics_noise=lambda r: noise[r]) for d in ("cpu", cuda)]
    cpu, card = runs
    assert (card.selected, card.received, card.comm_mb) == \
        (cpu.selected, cpu.received, cpu.comm_mb)
    np.testing.assert_allclose(card.wall_clock, cpu.wall_clock, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(card.acc, cpu.acc, rtol=0, atol=4 / 2048)


def test_dynamics_loop_launches_fed_agg_once_a_round(cuda):
    engine = _dyn_engine(cuda, depth=2, rounds=3)
    before = (K.launches.count, RK.launches.count)
    engine.run("flude", diagnostics=False)
    assert (K.launches.count - before[0], RK.launches.count - before[1]) \
        == (3, 0)


# ---------------------------------------------------------------------------
# Compact cohorts and host cache offload
# ---------------------------------------------------------------------------

def _cohort_engine(device, offload=None, depth=1, n=32, rounds=4, x=8,
                   dynamics="bernoulli"):
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import federated_classification
    from repro_torch.fl import FleetEngine, SimConfig
    fl = FLConfig(num_clients=n, clients_per_round=8, pipeline_depth=depth,
                  dynamics=dynamics, cohort_size=x, cache_offload=offload)
    return FleetEngine(federated_classification(n, seed=4, n_per_client=16),
                       SimConfig(num_clients=n, rounds=rounds, seed=3,
                                 local_steps=2, batch_size=8), fl,
                       device=device)


@pytest.mark.parametrize("offload", [None, "host"])
def test_cohort_loop_card_matches_cpu(cuda, offload):
    """N = 32, X = 8, 4 rounds under markov with the uniforms drawn once
    on the CPU: the same integer trajectory and comm on the card as on
    the CPU, wall clock within 1e-5, accuracy within 4 of 2048."""
    from repro_torch.fleet import draw_noise, get_dynamics
    proc = get_dynamics("markov")
    gen = torch.Generator().manual_seed(0)
    noise = {"init": draw_noise(proc.init_noise, 32, gen, "cpu")}
    for rnd in range(4):
        noise[rnd] = draw_noise(proc.step_noise, 32, gen, "cpu")
    us = [torch.rand(32, generator=gen) for _ in range(4)]
    cpu, card = (_cohort_engine(d, offload, dynamics="markov").run(
        "flude", explore_uniforms=lambda r: us[r],
        dynamics_noise=lambda r: noise[r]) for d in ("cpu", cuda))
    assert (card.selected, card.received, card.comm_mb) == \
        (cpu.selected, cpu.received, cpu.comm_mb)
    np.testing.assert_allclose(card.wall_clock, cpu.wall_clock, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(card.acc, cpu.acc, rtol=0, atol=4 / 2048)


def test_offload_rows_equal_resident_rows_on_the_card(cuda):
    rows = [_cohort_engine(cuda, mode).run("flude").to_json()
            for mode in (None, "host")]
    assert rows[0] == rows[1]


@pytest.mark.parametrize("D", [22026, 17410])
def test_fed_agg_at_the_cohort_shape(cuda, D):
    """The kernel at C = 512, the cohort paths' shape: whole block_c
    chunks, held to its plain version."""
    g = K.geometry(512, D)
    assert all((K.chunk_rows(g, 512, 8, i)[1]
                - K.chunk_rows(g, 512, 8, i)[0]) % 8 == 0
               for i in range(g.n_chunks))
    u, w = _inputs(512, D, seed=D, device=cuda, zero_frac=0.5)
    _check(K.fed_agg_cuda(u, w), u, w)


@pytest.mark.parametrize("offload", [None, "host"])
def test_cohort_loop_does_not_synchronise_outside_its_seams(cuda, offload):
    """A flude run at depth 2 under sync debug mode "error": the round
    ledger's resolve, the run-end read-back and the offload stream's two
    reads a round wait for the card, all through ``host_readback``."""
    engine = _cohort_engine(cuda, offload, depth=2, n=64, x=16)
    engine.run("flude")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hist = engine.run("flude", diagnostics=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(hist.acc) == 4
    assert engine.transfer_stats.sync_copies == 0


def test_cohort_loop_launches_fed_agg_once_a_round(cuda):
    engine = _cohort_engine(cuda, "host", rounds=3)
    before = K.launches.count
    engine.run("flude", diagnostics=False)
    assert K.launches.count - before == 3


# ---------------------------------------------------------------------------
# Thompson selection, telemetry and the invariant checks
# ---------------------------------------------------------------------------

def _slice_engine(device, n=64, rounds=3, **changes):
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import federated_classification
    from repro_torch.fl import FleetEngine, SimConfig
    fl = FLConfig(num_clients=n, clients_per_round=16, dynamics="bernoulli",
                  **changes)
    return FleetEngine(federated_classification(n, seed=1, n_per_client=32),
                       SimConfig(num_clients=n, rounds=rounds, seed=2,
                                 local_steps=2), fl, device=device)


def _history_rows(h):
    return (h.acc, h.wall_clock, h.comm_mb, h.received, h.selected,
            h.eval_mask)


@pytest.mark.parametrize("alpha,beta", [(2.0, 2.0), (0.7, 3.5)])
def test_thompson_sampler_on_the_card_is_beta_distributed(cuda, alpha,
                                                          beta):
    from scipy import stats
    from repro_torch.core.dependability import (BetaBelief,
                                                sample_dependability)
    n = 20_000
    belief = BetaBelief(torch.full((n,), alpha, device=cuda),
                        torch.full((n,), beta, device=cuda))
    draws = sample_dependability(
        belief, torch.Generator(device=cuda).manual_seed(3))
    again = sample_dependability(
        belief, torch.Generator(device=cuda).manual_seed(3))
    assert draws.device.type == "cuda" and torch.equal(draws, again)
    res = stats.kstest(draws.cpu().numpy(), stats.beta(alpha, beta).cdf)
    assert res.pvalue > 1e-3, res


@pytest.mark.parametrize("changes", [dict(), dict(cohort_size=16),
                                     dict(cohort_size=16,
                                          cache_offload="host")],
                         ids=["full_scan", "cohort", "offload"])
def test_full_telemetry_rows_and_update_norm_launches(cuda, changes):
    """telemetry="full" leaves the rows as they are and adds update_norm's
    kernels: one fed_agg and two residual_norms launches a round."""
    engine = _slice_engine(cuda, pipeline_depth=2, **changes)
    counts = []
    for level in (False, "full"):
        before = (K.launches.count, RK.launches.count)
        hist = engine.run("flude", diagnostics=False, telemetry=level)
        counts.append((K.launches.count - before[0],
                        RK.launches.count - before[1]))
        if level is False:
            off = hist
    assert _history_rows(hist) == _history_rows(off)
    assert counts == [(3, 0), (6, 6)]
    assert hist.metrics["selected_count"] == hist.selected
    assert all(np.isfinite(hist.metrics["agg_residual_max"]))


@pytest.mark.parametrize("changes", [dict(telemetry="full"),
                                     dict(debug_checks=True),
                                     dict(telemetry="full", cohort_size=16,
                                          cache_offload="host",
                                          debug_checks=True),
                                     dict(selection_mode="thompson")],
                         ids=["telemetry", "debug_checks", "all_offload",
                              "thompson"])
def test_slice_runs_do_not_synchronise_outside_host_readback(cuda,
                                                             changes):
    """Telemetry, the round guard and the Thompson sampler under sync
    debug mode "error": the only waits are through ``host_readback``,
    and the rows equal an unchecked, uninstrumented run's."""
    plain = _slice_engine(cuda, pipeline_depth=2, **{
        k: v for k, v in changes.items()
        if k in ("cohort_size", "cache_offload", "selection_mode")})
    engine = _slice_engine(cuda, pipeline_depth=2, **changes)
    want = plain.run("flude", diagnostics=False, telemetry=False)
    engine.run("flude")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hist = engine.run("flude", diagnostics=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _history_rows(hist) == _history_rows(want)


def test_round_guard_fires_on_a_card_nan(cuda):
    from repro_torch.analysis import runtime as RT
    guard = RT.make_round_guard(8, with_idx=True)
    ok = guard({"w": torch.ones(3, device=cuda)},
               torch.zeros(4, device=cuda), torch.tensor([0, 8], device=cuda))
    RT.check_round(ok, guard.messages, 1, cuda)
    bad = guard({"w": torch.tensor([1.0, float("nan")], device=cuda)},
                torch.zeros(4, device=cuda), torch.tensor([0, 8],
                                                          device=cuda))
    with pytest.raises(RT.RoundCheckError, match="round 2: non-finite"):
        RT.check_round(bad, guard.messages, 2, cuda)


@pytest.mark.parametrize("policy", ["flude", "random"])
@pytest.mark.parametrize("mode", ["full", "cohort", "offload"])
def test_audit_engine_clean_on_the_card(cuda, policy, mode):
    """The op checks on the card: no blocking device-to-host copy, no
    value read back, no float64 outside the ledger's row and in-place
    cohort writes over two rounds of each round path."""
    from repro_torch.analysis.audit import audit_engine, build_audited
    engine, pol, fleet = build_audited(policy, mode, device=cuda)
    report = audit_engine(engine, pol, fleet)
    assert report.ok(), report.summary()


# ---------------------------------------------------------------------------
# flash attention's backward kernel (fp32) and the refusals under grad
# ---------------------------------------------------------------------------

# dq, dk and dv against autograd through the plain version, both fp32:
# other summation orders over up to Sk keys and G query heads; each
# gradient within 1e-4 of max(1, max |g|) of its own tensor
FLASH_BWD_TOL = 1e-4


def _flash_grads(q, k, v, dout, impl, **kw):
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = FO.flash_attention(*leaves, impl=impl, **kw)
    return out, torch.autograd.grad(out, leaves, dout)


def _check_grads(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        bound = FLASH_BWD_TOL * max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,q_offset,causal,window", [
    (32, 8, 4, 128, 128, 32, 0, True, None),     # flude-paper training
    (4, 12, 4, 128, 128, 64, 0, True, None),     # 100m training
    (1, 12, 4, 700, 700, 64, 0, True, 256),      # window, ragged S
    (2, 3, 3, 100, 100, 64, 0, True, None),
    (2, 14, 2, 70, 107, 64, 37, True, None),     # q_offset, Sq < Sk
    (1, 7, 1, 130, 190, 64, 60, True, 50),
    (1, 4, 2, 65, 64, 80, 0, False, None),       # non-causal, ragged
    (2, 4, 2, 97, 97, 80, 0, True, 40),
    (1, 4, 4, 1, 77, 128, 76, True, None),       # one query
    (1, 8, 2, 200, 200, 128, 0, True, None),
    (1, 6, 2, 150, 150, 192, 0, True, 64),
    (1, 4, 1, 256, 256, 32, 0, False, 30),      # non-causal window
])
def test_flash_backward_kernel_matches_plain(cuda, B, Hq, Hkv, Sq, Sk, D,
                                             q_offset, causal, window):
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, D, torch.float32, cuda,
                   seed=Sq + D)
    dout = torch.randn_like(q)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = dict(FK.bwd_launches.by_variant)
    out, got = _flash_grads(q, k, v, dout, "cuda", **kw)
    torch.cuda.synchronize()
    ran = {n: c - before[n] for n, c in FK.bwd_launches.by_variant.items()}
    assert ran == {n: int(n == "wgmma_f32") for n in ran}
    _check_flash(out, q, k, v, **kw)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    _check_grads(got, attention_bwd_ref(q, k, v, dout, **kw))


FP32_BWD_CASES = [
    (32, 8, 4, 128, 128, 32, 0, True, None),     # flude-paper training
    (2, 12, 4, 300, 300, 64, 0, True, None),     # 100m's heads
    (1, 7, 1, 130, 190, 64, 60, True, 50),       # group 7, q_offset
    (2, 4, 2, 97, 97, 80, 0, True, 40),          # D 80, window
    (1, 4, 2, 65, 128, 80, 0, False, None),      # non-causal
    (1, 4, 4, 1, 77, 128, 76, True, None),       # one query
    (1, 8, 2, 200, 200, 128, 0, True, None),     # D 128
    (1, 6, 2, 150, 150, 192, 0, True, 64),       # D 192
    (2, 8, 2, 70, 107, 32, 37, True, None),      # D 32, Sq < Sk
    (4, 8, 4, 1100, 1100, 64, 0, True, None),    # a group a dk/dv block
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,q_offset,causal,window",
                         FP32_BWD_CASES)
def test_flash_backward_fp32_variants_pass_one_gate(cuda, B, Hq, Hkv, Sq,
                                                    Sk, D, q_offset, causal,
                                                    window):
    """The fp32 tensor-core kernels (``wgmma_f32``, every factor in three
    bf16 terms) and the SIMT ones asked for by name, on the same inputs,
    lse and output: each within FLASH_BWD_TOL of max(1, max |g|) and 1e-3
    of its own max |g| of autograd through the plain version, the two
    within FLASH_BWD_TOL of each other, each counted under its own
    variant; reruns bit-identical; the bf16 variants refuse fp32."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, D, torch.float32, cuda, seed=Sq + 9)
    dout = torch.randn_like(q)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = FK.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    want = attention_bwd_ref(q, k, v, dout, **kw)
    got = {}
    for variant in ("wgmma_f32", "simt"):
        before = dict(FK.bwd_launches.by_variant)
        got[variant] = FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                   variant=variant, **kw)
        torch.cuda.synchronize()
        ran = {n: c - before[n] for n, c in FK.bwd_launches.by_variant.items()}
        assert ran == {n: int(n == variant) for n in ran}
        _check_grads(got[variant], want)
        for g, w in zip(got[variant], want):
            assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max())
    _check_grads(got["wgmma_f32"], got["simt"])
    again = FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got["wgmma_f32"], again))
    for variant in ("wgmma_bf16", "simt_bf16"):
        with pytest.raises(ValueError, match="variant"):
            FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                        variant=variant, **kw)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(4, 12, 4, 256, 64),
                                          (8, 8, 4, 128, 32)])
def test_flash_backward_fp32_is_as_near_float64_as_plain(cuda, B, Hq, Hkv,
                                                         S, D):
    """dq, dk and dv of the fp32 kernels (the forward's out and lse, then
    ``wgmma_f32``) no more than 2x as far from a float64 truth (autograd
    through the plain version in float64) as the plain fp32 attention's,
    each as a share of max(1, max |g|): the rule chip_smoke.py holds it
    to at its larger shapes."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    q, k, v = _qkv(B, Hq, Hkv, S, S, D, torch.float32, cuda, seed=S + 1)
    dout = torch.randn_like(q)
    truth = attention_bwd_ref(q.double(), k.double(), v.double(),
                              dout.double())
    plain = attention_bwd_ref(q, k, v, dout)
    out, lse = FK.flash_attention_cuda(q, k, v, with_lse=True)
    got = FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout)

    def share(x, t):
        return float((x.double() - t).abs().max()) / max(
            1.0, float(t.abs().max()))
    for name, g, p, t in zip(("dq", "dk", "dv"), got, plain, truth):
        assert share(g, t) <= 2 * share(p, t), name


def test_flash_backward_kernel_is_deterministic(cuda):
    q, k, v = _qkv(2, 12, 4, 300, 300, 64, torch.float32, cuda)
    dout = torch.randn_like(q)
    one = _flash_grads(q, k, v, dout, "cuda")[1]
    two = _flash_grads(q, k, v, dout, "cuda")[1]
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_flash_backward_through_the_model_layout(cuda):
    """The training forward's call: strided (B, H, S, D) views of the
    (B, S, Hk, G, D) projections, gradients laid out as they are, against
    the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, 130, 4, 3, 64), generator=gen, device=cuda)
    k = torch.randn((2, 130, 4, 64), generator=gen, device=cuda)
    v = torch.randn((2, 130, 4, 64), generator=gen, device=cuda)
    dout = torch.randn_like(q)
    grads = {}
    for impl in ("cuda", "torch"):
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = FO.flash_attention_model_layout(*leaves, causal=True,
                                              impl=impl)
        grads[impl] = torch.autograd.grad(out, leaves, dout)
    _check_grads(grads["cuda"], grads["torch"])


def test_flash_backward_refuses_rows_without_keys(cuda):
    """Rows at positions 285 and on see none of the 256 keys (window
    30): the forward averages V there, the backward kernel refuses."""
    q, k, v = _qkv(1, 4, 2, 160, 256, 64, torch.float32, cuda)
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="see a key"):
        FO.flash_attention(q, k, v, causal=False, window=30, q_offset=200)
    with torch.no_grad():        # without grad the forward takes them
        FO.flash_attention(q, k, v, causal=False, window=30, q_offset=200)


def test_kernels_without_a_backward_refuse_grad(cuda):
    """bf16 rwkv6_scan has no backward kernel: under grad it raises naming
    #15g step 3 rather than return an output with no gradient; without
    grad, or with the plain version, it runs.  bf16 flash and ssm_scan
    have theirs now and take grad through the kernels.  fed_agg and
    residual_norms have none (the FL server step runs under no_grad) and
    raise too."""
    from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    q, k, v = _qkv(1, 4, 2, 64, 64, 64, torch.bfloat16, cuda)
    q.requires_grad_(True)
    before = FK.bwd_launches.by_variant["wgmma_bf16"]
    FO.flash_attention(q, k, v).float().sum().backward()
    assert q.grad is not None and q.grad.dtype == torch.bfloat16
    assert FK.bwd_launches.by_variant["wgmma_bf16"] == before + 1
    x, dt, A, Bm, Cm, _ = _ssd_inputs(1, 64, 4, 32, 16, 1, torch.bfloat16,
                                      cuda)
    x.requires_grad_(True)
    before = SK.bwd_launches.by_variant["mma_bf16"]
    ssm_scan(x, dt, A, Bm, Cm)[0].sum().backward()
    assert x.grad is not None and x.grad.dtype == torch.bfloat16
    assert SK.bwd_launches.by_variant["mma_bf16"] == before + 1
    x.grad = None
    ssm_scan(x, dt, A, Bm, Cm, impl="torch")[0].sum().backward()
    assert x.grad is not None
    with torch.no_grad():
        ssm_scan(x, dt, A, Bm, Cm)
    args = _wkv_inputs(1, 64, 2, 32, torch.bfloat16, cuda)
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="#15g step 3"):
        wkv_kernel_adapter("cuda")(*args)
    with torch.no_grad():
        wkv_kernel_adapter("cuda")(*args)
    u, w = _inputs(64, 1000, 0, cuda)
    u.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="fed_agg cuda"):
        fed_agg_packed(u, w)
    with pytest.raises(NotImplementedError, match="residual_norms cuda"):
        RO.residual_norms(u, u[0].detach())
    with torch.no_grad():
        fed_agg_packed(u, w)
        RO.residual_norms(u, u[0])
    assert fed_agg_packed(u, w, impl="torch").requires_grad


# the scans' backward kernels against autograd through the per-step
# oracles: per gradient tensor within 2e-4 (SSD) / 1e-4 (WKV) of max(1,
# max |g|) and within 1e-3 of its own max |g| (a zero gradient fails it),
# as chip_smoke.py gates them
SSD_BWD_TOL, WKV_BWD_TOL, OWN_MAX_TOL = 2e-4, 1e-4, 1e-3


def _check_scan_grads(got, want, tol):
    """A plain gradient that is exactly 0 (dA at one step from a zero
    state, dlogw with no final-state gradient) has no own max to hold
    the kernel's to: only the first gate applies there."""
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        assert err <= tol * max(1.0, scale)
        assert scale == 0.0 or err <= OWN_MAX_TOL * scale


def _scan_grads(fn, leaves, dy, dlast):
    leaves = [None if t is None else t.detach().requires_grad_(True)
              for t in leaves]
    y, last = fn(*leaves)
    loss = (y * dy).sum() + ((last * dlast).sum() if dlast is not None
                             else 0.0)
    live = [t for t in leaves if t is not None]
    # an input the loss does not reach (logw at one step with no final-
    # state gradient) has gradient 0
    got = iter(torch.autograd.grad(loss, live, allow_unused=True,
                                   materialize_grads=True))
    return [None if t is None else next(got) for t in leaves]


@pytest.mark.parametrize("B,S,H,P,N,G,h0,dhf", [
    (2, 130, 4, 32, 16, 2, True, True),             # ragged, G 2, states
    (4, 128, 6, 64, 64, 1, False, False),           # a training shape
    (1, 77, 4, 64, 16, 4, True, False),
    (2, 1, 2, 32, 64, 1, False, True),              # one step
    (1, 1000, 2, 64, 64, 1, False, False),          # ragged S 1000
])
def test_ssm_scan_backward_kernel_matches_plain(cuda, B, S, H, P, N, G, h0,
                                               dhf):
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    x, dt, A, Bm, Cm, hh = _ssd_inputs(B, S, H, P, N, G, torch.float32, cuda,
                                       seed=S + H, h0=h0)
    dy = torch.randn_like(x)
    dh = torch.randn((B, H, P, N), device=cuda) if dhf else None
    before = (SK.launches.count, SK.bwd_launches.count)
    got = _scan_grads(ssm_scan, [x, dt, A, Bm, Cm, hh], dy, dh)
    torch.cuda.synchronize()
    assert (SK.launches.count, SK.bwd_launches.count) == (
        before[0] + 1, before[1] + 1)
    want = _scan_grads(_ssd_plain, [x, dt, A, Bm, Cm, hh], dy, dh)
    _check_scan_grads(got, want, SSD_BWD_TOL)


@pytest.mark.parametrize("B,S,H,P,N,G,h0,dhf", [
    (2, 130, 4, 32, 16, 2, True, True),             # ragged, G 2, states
    (4, 300, 8, 64, 64, 2, True, True),             # workspace, G 2
    (3, 64, 6, 64, 16, 3, False, True),             # 3 heads a group
    (2, 200, 4, 32, 64, 2, False, False),
])
def test_ssm_scan_backward_fp32_variants_pass_one_gate(cuda, B, S, H, P, N,
                                                      G, h0, dhf):
    """fp32 under grad runs the tensor-core backward (``mma_f32``); it
    and ``ssd_bwd_simt`` asked for by name, on the same inputs, each
    within the gate of autograd through the per-step oracle and counted
    under its own variant; reruns bit-identical; fp32 refuses the bf16
    variants."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    x, dt, A, Bm, Cm, hh = _ssd_inputs(B, S, H, P, N, G, torch.float32,
                                       cuda, seed=S + 9, h0=h0)
    dy = torch.randn(x.shape, device=cuda)
    dh = torch.randn((B, H, P, N), device=cuda) if dhf else None
    args = [x, dt, A, Bm, Cm, hh]
    want = _scan_grads(_ssd_plain, args, dy, dh)
    before = dict(SK.bwd_launches.by_variant)
    got = _scan_grads(ssm_scan, args, dy, dh)
    again = _scan_grads(ssm_scan, args, dy, dh)
    torch.cuda.synchronize()
    ran = {n: c - before[n] for n, c in SK.bwd_launches.by_variant.items()}
    assert ran == {n: 2 * (n == "mma_f32") for n in ran}
    _check_scan_grads(got, want, SSD_BWD_TOL)
    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again))
    k = [t.transpose(1, 2) for t in (x, dt, Bm, Cm, dy)]

    def model_layout(out):
        return [t.transpose(1, 2) if i in (0, 1, 3, 4) else t
                for i, t in enumerate(out)]
    for variant in ("mma_f32", "simt"):
        before = dict(SK.bwd_launches.by_variant)
        out = SK.ssm_scan_bwd_cuda(k[0], k[1], A, k[2], k[3], hh, k[4], dh,
                                   variant=variant)
        torch.cuda.synchronize()
        ran = {n: c - before[n] for n, c in SK.bwd_launches.by_variant.items()}
        assert ran == {n: int(n == variant) for n in ran}
        _check_scan_grads(model_layout(out), want, SSD_BWD_TOL)
    for bad in ("mma_bf16", "simt_bf16"):
        with pytest.raises(ValueError, match="variant"):
            SK.ssm_scan_bwd_cuda(k[0], k[1], A, k[2], k[3], hh, k[4], dh,
                                 variant=bad)


def test_ssm_scan_backward_fp32_rows_it_cannot_read(cuda):
    """``mma_f32`` reads the rows of fp32 x, B, C and dy as float4: a row
    stride that is no multiple of 16 bytes raises before a launch, the
    SIMT variant takes it, and ``SSDScanFn`` copies such an input (the
    fp32 forward takes any layout), its gradient still the oracle's."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    B, S, H, P, N = 1, 70, 2, 32, 16
    wide = torch.randn((B, S, H * P + 2 * N + 2), device=cuda) * 0.5
    x, Bm, Cm, _ = torch.split(wide, [H * P, N, N, 2], -1)
    x, Bm, Cm = x.reshape(B, S, H, P), Bm.reshape(B, S, 1, N), \
        Cm.reshape(B, S, 1, N)                      # a 98-float row
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), device=cuda))
    A = -(torch.rand((H,), device=cuda) * 4 + 0.5)
    dy = torch.randn((B, S, H, P), device=cuda)
    k = [t.transpose(1, 2) for t in (x, dt, Bm, Cm, dy)]
    with pytest.raises(ValueError, match="16 bytes"):
        SK.ssm_scan_bwd_cuda(k[0], k[1], A, k[2], k[3], None, k[4])
    simt = SK.ssm_scan_bwd_cuda(k[0], k[1], A, k[2], k[3], None, k[4],
                                variant="simt")
    assert bool(torch.isfinite(simt[0]).all())
    args = [x, dt, A, Bm, Cm, None]
    before = SK.bwd_launches.by_variant["mma_f32"]
    got = _scan_grads(ssm_scan, args, dy, None)
    assert SK.bwd_launches.by_variant["mma_f32"] == before + 1
    _check_scan_grads(got, _scan_grads(_ssd_plain, args, dy, None),
                      SSD_BWD_TOL)


@pytest.mark.parametrize("B,S,H,D,s0,dsf", [
    (1, 100, 4, 32, True, True),                    # ragged, D 32, states
    (4, 128, 3, 64, False, False),                  # a training shape
    (2, 1, 2, 64, True, False),                     # one step
    (1, 1000, 2, 32, False, True),                  # ragged S 1000
])
def test_rwkv6_scan_backward_kernel_matches_plain(cuda, B, S, H, D, s0, dsf):
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter
    args = list(_wkv_inputs(B, S, H, D, torch.float32, cuda, seed=S + D,
                            s0=s0))
    dy = torch.randn_like(args[0])
    ds = torch.randn((B, H, D, D), device=cuda) if dsf else None
    before = (WK.launches.count, WK.bwd_launches.count)
    got = _scan_grads(wkv_kernel_adapter("cuda"), args, dy, ds)
    torch.cuda.synchronize()
    assert (WK.launches.count, WK.bwd_launches.count) == (
        before[0] + 1, before[1] + 1)
    want = _scan_grads(wkv_kernel_adapter("torch"), args, dy, ds)
    _check_scan_grads(got, want, WKV_BWD_TOL)


def test_scan_backward_kernels_are_deterministic(cuda):
    from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    ssd = _ssd_inputs(2, 300, 4, 64, 64, 2, torch.float32, cuda, h0=True)
    dy = torch.randn_like(ssd[0])
    one, two = (_scan_grads(ssm_scan, list(ssd), dy, None) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    wkv = _wkv_inputs(2, 300, 4, 64, torch.float32, cuda, s0=True)
    dy = torch.randn_like(wkv[0])
    one, two = (_scan_grads(wkv_kernel_adapter("cuda"), list(wkv), dy, None)
                for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_training_forward_gives_attention_weights_a_gradient(cuda):
    """The fault this guards against: the flash kernel's output, filled
    through ctypes, carried no ``grad_fn``, so a loss through it gave
    wq, wk and wv no gradient and raised nothing.  Now the backward
    kernel gives every attention weight a finite, non-zero gradient that
    matches the plain attention's; under remat the forward runs twice a
    layer, the backward once."""
    from repro_torch.configs import get_config
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.tree import tree_leaves, tree_unflatten
    cfg = get_config("flude-paper")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (8, 129), generator=gen,
                        device=cuda)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    grads = {}
    for impl in ("cuda", "torch"):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        fwd, bwd = FK.launches.count, FK.bwd_launches.count
        loss, _ = model.loss(tree_unflatten(params, leaves), batch,
                             ExecConfig(attn_impl=impl))
        g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        launched = (FK.launches.count - fwd, FK.bwd_launches.count - bwd)
        assert launched == ((2 * cfg.num_layers, cfg.num_layers)
                            if impl == "cuda" else (0, 0))
        grads[impl] = tree_unflatten(params, list(g))
    for layer in grads["cuda"]["blocks"]:
        for w in ("wq", "wk", "wv"):
            g = layer["attn"][w]
            assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    for g, w in zip(tree_leaves(grads["cuda"]), tree_leaves(grads["torch"])):
        bound = FLASH_BWD_TOL * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= bound


def test_train_driver_on_the_card_matches_cpu(cuda):
    """The driver at 4 silos x 4 x 32 from one set of parameters and one
    set of explore uniforms: selected and received identical, the loss
    within 1e-4 relative (fp32, other summation orders)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    argv = ["--rounds", "4", "--silos", "4", "--seq-len", "32",
            "--log-every", "100"]
    params = build_model(get_config("flude-paper")).init(
        torch.Generator().manual_seed(0))
    u = torch.rand((4, 4), generator=torch.Generator().manual_seed(1))
    logs = {}
    for dev in ("cpu", "cuda"):
        _, logs[dev] = T.main(argv + ["--device", dev],
                              params=tree_map(lambda t: t.to(dev), params),
                              explore_uniforms=lambda rnd: u[rnd])
    for key in ("selected", "received", "epsilon"):
        assert [r[key] for r in logs["cuda"]] == [r[key] for r in
                                                  logs["cpu"]]
    np.testing.assert_allclose([r["loss"] for r in logs["cuda"]],
                               [r["loss"] for r in logs["cpu"]], rtol=1e-4)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_recurrent_train_driver_on_the_card_matches_cpu(cuda, arch):
    """The recurrent stacks at --scale 10m, 4 silos x 4 x 32, 2 rounds,
    from one set of parameters and explore uniforms: the card's kernels
    and backward kernels against the CPU's plain forms, trajectories
    identical, the loss within 1e-4 relative."""
    from repro_torch.configs import scaled_config
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.launch import train as T
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    argv = ["--arch", arch, "--scale", "10m", "--rounds", "2", "--silos",
            "4", "--seq-len", "32", "--log-every", "100"]
    params = build_model(scaled_config(arch, "10m")).init(
        torch.Generator().manual_seed(0))
    u = torch.rand((2, 4), generator=torch.Generator().manual_seed(1))
    bwd = SK.bwd_launches if arch.startswith("zamba2") else WK.bwd_launches
    before = bwd.count
    logs = {}
    for dev in ("cpu", "cuda"):
        _, logs[dev] = T.main(argv + ["--device", dev],
                              params=tree_map(lambda t: t.to(dev), params),
                              explore_uniforms=lambda rnd: u[rnd])
    assert bwd.count == before + 2 * 6            # 6 layers, 2 steps
    for key in ("selected", "received", "epsilon"):
        assert [r[key] for r in logs["cuda"]] == [r[key] for r in
                                                  logs["cpu"]]
    np.testing.assert_allclose([r["loss"] for r in logs["cuda"]],
                               [r["loss"] for r in logs["cpu"]], rtol=1e-4)


# ---------------------------------------------------------------------------
# the bf16 backwards of flash and ssm_scan
# ---------------------------------------------------------------------------

# each bf16 gradient against autograd through the plain version in fp32 on
# the same bf16 values, upcast: its excess beyond one bf16 ulp of the
# truth within the fp32 gate of max(1, max |g|) and within 1e-3 of its own
# max |g| (ref.bf16_grad_gate, as chip_smoke.py gates them); fp32 outputs
# without the ulp
def _check_bf16_grads(got, want, dtypes, tol):
    from repro_torch.kernels.flash_attention.ref import bf16_grad_gate
    for g, w, dt in zip(got, want, dtypes):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and g.dtype == dt
        assert bool(torch.isfinite(g).all())
        err, scale, ok = bf16_grad_gate(g, w, tol)
        assert ok, (err, scale)


# every head dim at GQA groups 1, 4 and 7, with ragged Sq and Sk, windows,
# q_offset and non-causal calls among them; the training shape of
# zamba2-1.2b's heads; groups of 4 and 7 both under two waves of blocks
# (one query head a block, summed after) and above (the group in a block)
BF16_BWD_CASES = [
    # (B, Hq, Hkv, Sq, Sk, D, q_offset, causal, window)
    (4, 32, 32, 128, 128, 64, 0, True, None),    # zamba2-1.2b's heads
    (1, 8, 2, 700, 700, 80, 0, True, 256),       # Danube's D, a window
    (2, 14, 2, 70, 107, 128, 37, True, None),    # q_offset, Sq < Sk
    (1, 4, 2, 65, 128, 32, 0, False, None),      # non-causal, D 32
    (1, 6, 2, 150, 150, 192, 0, True, 64),
    (2, 2, 2, 97, 97, 32, 0, True, 40),          # D 32, G 1, ragged
    (1, 8, 2, 200, 200, 32, 0, True, None),      # D 32, G 4
    (1, 7, 1, 130, 190, 32, 60, True, 50),       # D 32, G 7
    (2, 3, 3, 130, 130, 64, 0, True, 50),        # D 64, G 1, window
    (1, 8, 2, 190, 250, 64, 60, True, None),     # D 64, G 4, q_offset
    (1, 7, 1, 130, 190, 64, 60, True, 50),       # D 64, G 7
    (4, 16, 4, 1100, 1100, 64, 0, True, None),   # D 64, G 4, group a block
    (1, 2, 2, 77, 77, 80, 0, True, None),        # D 80, G 1, ragged
    (1, 7, 1, 65, 128, 80, 0, False, None),      # D 80, G 7, non-causal
    (2, 2, 2, 100, 100, 128, 0, True, 30),       # D 128, G 1
    (1, 8, 2, 129, 129, 128, 0, True, None),     # D 128, G 4
    (1, 7, 1, 333, 1000, 128, 667, True, 100),   # D 128, G 7, window
    (7, 28, 4, 600, 600, 128, 0, True, None),    # D 128, G 7, group a block
    (2, 3, 3, 130, 130, 192, 0, True, None),     # D 192, G 1
    (1, 8, 2, 150, 256, 192, 0, False, None),    # D 192, G 4, non-causal
    (1, 7, 1, 100, 140, 192, 40, True, 70),      # D 192, G 7
    (5, 8, 2, 1700, 1700, 192, 0, True, 300),    # D 192, G 4, group a block
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,q_offset,causal,window",
                         BF16_BWD_CASES)
def test_flash_backward_kernel_in_bf16_matches_plain(cuda, B, Hq, Hkv, Sq,
                                                     Sk, D, q_offset, causal,
                                                     window):
    """Under grad, bf16 runs flash_fwd_wgmma with its lse and the
    tensor-core backward (``wgmma_bf16``); each gradient bf16, held as
    above; reruns bit-identical."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, D, torch.bfloat16, cuda, seed=Sq + D)
    dout = torch.randn_like(q, dtype=torch.float32).to(torch.bfloat16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = (dict(FK.launches_by_variant), dict(FK.lse_launches.by_variant),
              dict(FK.bwd_launches.by_variant))
    out, got = _flash_grads(q, k, v, dout, "cuda", **kw)
    torch.cuda.synchronize()
    assert (FK.launches_by_variant["wgmma"],
            FK.lse_launches.by_variant["wgmma"],
            FK.bwd_launches.by_variant["wgmma_bf16"],
            FK.bwd_launches.by_variant["simt_bf16"],
            FK.bwd_launches.by_variant["simt"],
            FK.bwd_launches.by_variant["wgmma_f32"]) == (
        before[0]["wgmma"] + 1, before[1]["wgmma"] + 1,
        before[2]["wgmma_bf16"] + 1, before[2]["simt_bf16"],
        before[2]["simt"], before[2]["wgmma_f32"])
    _check_flash(out, q, k, v, **kw)
    _check_bf16_grads(got, attention_bwd_ref(q.float(), k.float(), v.float(),
                                             dout.float(), **kw),
                      (torch.bfloat16,) * 3, FLASH_BWD_TOL)
    again = _flash_grads(q, k, v, dout, "cuda", **kw)[1]
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,q_offset,causal,window", [
    BF16_BWD_CASES[0], BF16_BWD_CASES[1], BF16_BWD_CASES[7],
    BF16_BWD_CASES[16], BF16_BWD_CASES[20]])
def test_flash_backward_bf16_variants_pass_one_gate(cuda, B, Hq, Hkv, Sq,
                                                    Sk, D, q_offset, causal,
                                                    window):
    """The tensor-core kernels and the SIMT ones asked for by name, on the
    same bf16 inputs, lse and output: both within the gate of the truth,
    each counted under its own variant."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, D, torch.bfloat16, cuda, seed=Sq + 3)
    dout = torch.randn_like(q, dtype=torch.float32).to(torch.bfloat16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = FK.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    want = attention_bwd_ref(q.float(), k.float(), v.float(), dout.float(),
                             **kw)
    for variant in ("wgmma_bf16", "simt_bf16"):
        before = dict(FK.bwd_launches.by_variant)
        got = FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                          variant=variant, **kw)
        torch.cuda.synchronize()
        ran = {n: c - before[n] for n, c in FK.bwd_launches.by_variant.items()}
        assert ran == {n: int(n == variant) for n in ran}
        _check_bf16_grads(got, want, (torch.bfloat16,) * 3, FLASH_BWD_TOL)
    with pytest.raises(ValueError, match="variant"):
        FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout, variant="simt",
                                    **kw)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window", [
    (4, 32, 32, 128, 64, None), (1, 8, 2, 700, 80, 256),
    (1, 7, 1, 300, 128, None), (2, 4, 4, 100, 32, 40),
    (1, 6, 2, 150, 192, None)])
def test_wgmma_lse_equals_simt_lse(cuda, B, Hq, Hkv, S, D, window):
    """flash_fwd_wgmma's log-sum-exp (natural log, from m in log2 units)
    against flash_fwd_simt's on the same bf16 values upcast: within 1e-5
    of max(1, |lse|) row by row (both sum l from the fp32 P)."""
    q, k, v = _qkv(B, Hq, Hkv, S, S, D, torch.bfloat16, cuda, seed=S)
    lse = FK.flash_attention_cuda(q, k, v, window=window, with_lse=True)[1]
    want = FK.flash_attention_cuda(q.float(), k.float(), v.float(),
                                   window=window, with_lse=True,
                                   variant="simt")[1]
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32
    assert bool(((lse - want).abs() <= 1e-5 * want.abs().clamp_min(1.0))
                .all()), float((lse - want).abs().max())


# every (P, N) with fp32 and bf16 dt, groups 1 to 4, ragged S (in the last
# chunk, in the first, one step), h0 and dh_f set and null, one and
# several heads a block of the tensor-core kernel (heads_per_block), and
# its workspace (S > 128)
SSD_BF16_BWD_CASES = [
    # (B, S, H, P, N, G, h0, dh_f, bf16 dt)
    (4, 128, 8, 64, 64, 1, False, False, False),    # a training shape
    (2, 130, 4, 32, 16, 2, True, True, True),       # ragged, G 2, bf16 dt
    (1, 1000, 2, 64, 64, 1, False, True, False),    # ragged S 1000
    (2, 1, 2, 32, 64, 1, True, False, True),        # one step
    (1, 77, 8, 64, 16, 4, True, False, False),      # G 4, one chunk
    (2, 200, 4, 32, 64, 2, False, True, True),      # P 32 / N 64, G 2
    (3, 64, 6, 64, 16, 3, True, True, True),        # 3 heads a group
    (2, 33, 4, 32, 16, 1, False, False, False),     # S in the first chunk
    (16, 300, 64, 64, 64, 2, True, True, False),    # four heads a block
    (32, 128, 64, 64, 64, 1, False, False, False),  # zamba2-1.2b: eight
]


@pytest.mark.parametrize("B,S,H,P,N,G,h0,dhf,dt_bf16", SSD_BF16_BWD_CASES)
def test_ssm_scan_backward_kernel_in_bf16_matches_plain(cuda, B, S, H, P, N,
                                                       G, h0, dhf, dt_bf16):
    """bf16 x, B and C under grad: ssd_fwd_mma forward, the tensor-core
    backward (``mma_bf16``); each gradient in its input's dtype, against
    autograd through the per-step oracle in fp32 on the values upcast;
    reruns bit-identical."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    x, dt, A, Bm, Cm, hh = _ssd_inputs(B, S, H, P, N, G, torch.bfloat16,
                                       cuda, seed=S + H, h0=h0)
    if dt_bf16:
        dt = dt.to(torch.bfloat16)
    dy = torch.randn(x.shape, device=cuda)
    dh = torch.randn((B, H, P, N), device=cuda) if dhf else None
    args = [x, dt, A, Bm, Cm, hh]
    before = (dict(SK.launches.by_variant), dict(SK.bwd_launches.by_variant))
    got = _scan_grads(ssm_scan, args, dy, dh)
    torch.cuda.synchronize()
    assert (SK.launches.by_variant["mma"],
            SK.bwd_launches.by_variant["mma_bf16"],
            SK.bwd_launches.by_variant["simt_bf16"]) == (
        before[0]["mma"] + 1, before[1]["mma_bf16"] + 1,
        before[1]["simt_bf16"])
    want = _scan_grads(_ssd_plain, [None if t is None else t.float()
                                    for t in args], dy, dh)
    _check_bf16_grads(got, want, [None if t is None else t.dtype
                                  for t in args], SSD_BWD_TOL)
    again = _scan_grads(ssm_scan, args, dy, dh)
    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("B,S,H,P,N,G,h0,dhf,dt_bf16", [
    SSD_BF16_BWD_CASES[i] for i in (0, 1, 3, 4, 5, 8)])
def test_ssm_scan_backward_bf16_variants_pass_one_gate(cuda, B, S, H, P, N,
                                                      G, h0, dhf, dt_bf16):
    """The tensor-core kernel and the SIMT one asked for by name, on the
    same bf16 inputs: both within the gate of the truth, each counted
    under its own variant; fp32's ``simt`` refuses bf16."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    x, dt, A, Bm, Cm, hh = _ssd_inputs(B, S, H, P, N, G, torch.bfloat16,
                                       cuda, seed=S + 7, h0=h0)
    if dt_bf16:
        dt = dt.to(torch.bfloat16)
    dy = torch.randn(x.shape, device=cuda)
    dh = torch.randn((B, H, P, N), device=cuda) if dhf else None
    want = _scan_grads(_ssd_plain, [None if t is None else t.float()
                                    for t in (x, dt, A, Bm, Cm, hh)], dy, dh)
    k = [t.transpose(1, 2) for t in (x, dt, Bm, Cm, dy)]
    for variant in ("mma_bf16", "simt_bf16"):
        before = dict(SK.bwd_launches.by_variant)
        got = SK.ssm_scan_bwd_cuda(k[0], k[1], A, k[2], k[3], hh, k[4], dh,
                                   variant=variant)
        torch.cuda.synchronize()
        ran = {n: c - before[n] for n, c in SK.bwd_launches.by_variant.items()}
        assert ran == {n: int(n == variant) for n in ran}
        got = [t.transpose(1, 2) if i in (0, 1, 3, 4) else t
               for i, t in enumerate(got)]                # model layout
        _check_bf16_grads(got, want, [t.dtype if t is not None else None
                                      for t in (x, dt, A, Bm, Cm, hh)],
                          SSD_BWD_TOL)
    with pytest.raises(ValueError, match="variant"):
        SK.ssm_scan_bwd_cuda(k[0], k[1], A, k[2], k[3], hh, k[4], dh,
                             variant="simt")


def test_ssm_scan_backward_mma_refuses_rows_it_cannot_read(cuda):
    """The tensor-core backward copies rows of bf16 x, B and C 16 bytes at
    a time (cp.async) and reads fp32 dy as float4: strides that are no
    multiple of 16 bytes, or a base off 16 bytes, raise before a launch
    (``SSDScanFn`` copies such a dy); the SIMT variant takes them."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    x, dt, A, Bm, Cm, _ = _ssd_inputs(1, 64, 2, 32, 16, 1, torch.bfloat16,
                                      cuda)
    k = [t.transpose(1, 2) for t in (x, dt, Bm, Cm)]
    dy = torch.randn((1, 64, 2, 34), device=cuda)[..., :32].transpose(1, 2)
    with pytest.raises(ValueError, match="16 bytes"):
        SK.ssm_scan_bwd_cuda(k[0], k[1], A, k[2], k[3], None, dy)
    got = SK.ssm_scan_bwd_cuda(k[0], k[1], A, k[2], k[3], None, dy,
                               variant="simt_bf16")
    assert bool(torch.isfinite(got[0].float()).all())
    wide = torch.randn((1, 64, 2, 36), device=cuda).to(torch.bfloat16)
    xs = wide[..., :32].transpose(1, 2)              # a 72-byte row stride
    with pytest.raises(ValueError, match="16 bytes"):
        SK.ssm_scan_bwd_cuda(xs, k[1], A, k[2], k[3], None,
                             dy.contiguous())


def test_bf16_training_step_of_narrow_zamba2_runs_the_kernels(cuda):
    """One step of ``Model.loss`` of a narrow bf16 zamba2
    (``zamba2-1.2b.reduced()`` in bf16: 4 Mamba2 layers, 2 shared-
    attention applications) on the card: no ``NotImplementedError``, the
    bf16 kernels' launches as ``remat`` predicts (forwards twice, the
    backwards once), every gradient bf16, finite and non-zero."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.tree import tree_leaves, tree_unflatten
    cfg = get_config("zamba2-1.2b").reduced(param_dtype="bfloat16",
                                            compute_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (4, 129), generator=gen,
                        device=cuda)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    counts = (FK.launches_by_variant, FK.bwd_launches.by_variant,
              SK.launches.by_variant, SK.bwd_launches.by_variant)
    before = [dict(c) for c in counts]
    loss, _ = model.loss(tree_unflatten(params, leaves),
                         {"tokens": tok[:, :-1], "labels": tok[:, 1:]},
                         ExecConfig(attn_impl="cuda"))
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    ran = [{v: c[v] - b[v] for v in c} for c, b in zip(counts, before)]
    assert ran == [{"wgmma": 4, "wgmma_f32": 0, "simt": 0},
                   {"wgmma_f32": 0, "simt": 0, "wgmma_bf16": 2,
                    "simt_bf16": 0},
                   {"mma": 8, "simt": 0},
                   {"simt": 0, "mma_bf16": 4, "simt_bf16": 0, "mma_f32": 0}]
    assert bool(torch.isfinite(loss))
    for g in grads:
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
    assert all(bool(g.abs().max() > 0) for g in grads)
