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

from repro_torch.kernels.fed_agg import kernel as K
from repro_torch.kernels.fed_agg.ops import fed_agg_packed
from repro_torch.kernels.fed_agg.ref import fed_agg_ref

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
