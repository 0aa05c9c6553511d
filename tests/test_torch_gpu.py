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
                                 (13, 2049), (1, 5), (517, 300)])
def test_fed_agg_kernel_matches_plain(cuda, C, D):
    u, w = _inputs(C, D, seed=C + D, device=cuda, zero_frac=0.5)
    got = fed_agg_packed(u, w, impl="cuda")
    torch.cuda.synchronize()
    _check(got, u, w)


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
