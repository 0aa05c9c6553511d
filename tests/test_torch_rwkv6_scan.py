"""The port's WKV6 scan against the JAX reference, on the CPU.

On the same numpy inputs (fp32 unless a case says bf16):

* the port's per-step oracle ``rwkv6_scan_ref`` against JAX's;
* ``ops.rwkv6_scan`` (kernel layout) under ``impl="torch"`` and
  ``impl="cuda"`` (a CPU tensor takes the plain version) against JAX's
  ``rwkv6_scan`` under ``impl="xla"`` and ``impl="pallas_interpret"``:
  ragged S, D 32 and 64, a nonzero s0;
* ``wkv_kernel_adapter`` in the model layout, and plugged into the
  port's ``time_mix`` against the reference's ``time_mix`` with its own
  adapter;
* a carried state: two calls over the halves of S equal one call;
* the wrapper's contract: unknown impls, the CUDA wrapper refusing CPU
  tensors.

The CUDA kernel itself is held to ``rwkv6_scan_ref`` on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as jax_rwkv6_scan
from repro.kernels.rwkv6_scan.ops import \
    wkv_kernel_adapter as jax_wkv_adapter
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as jax_ref
from repro.models import build_model as ref_build_model
from repro.models import rwkv as RR

from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6_scan import kernel as K
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.models import rwkv as R

# Both sides run the exact per-step recurrence in fp32 (the Pallas kernel
# too) and differ in the einsums' summation order: a few ulps of |y|
TOL = dict(rtol=1e-5, atol=1e-5)
# time_mix: the same recurrence under the projections, the ddlerp and
# the group norm, a few ulps each
MIX_TOL = dict(rtol=1e-4, atol=1e-4)

# (B, H, S, D, chunk, dtype, with s0)
CASES = [
    (2, 2, 48, 32, 16, "float32", False),
    (1, 4, 100, 32, 32, "float32", True),     # ragged S, s0
    (2, 2, 64, 64, 64, "float32", False),     # full-width heads
    (1, 3, 77, 64, 32, "float32", True),      # ragged, D 64, s0
    (1, 2, 32, 32, 16, "bfloat16", True),     # bf16 r, k, v
]


def _inputs(B, H, S, D, dtype, with_s0, seed=0):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, H, S, D).astype(np.float32) * 0.5
               for _ in range(3))
    lw = -np.exp(rng.randn(B, H, S, D) * 0.5).astype(np.float32)
    u = (rng.randn(H, D) * 0.3).astype(np.float32)
    s0 = (rng.randn(B, H, D, D) * 0.5).astype(np.float32) if with_s0 \
        else None
    if dtype == "bfloat16":
        r, k, v = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for a in (r, k, v))
    return r, k, v, lw, u, s0


def _t(a, dtype="float32"):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _j(a, dtype="float32"):
    if a is None:
        return None
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else
                       jnp.float32)


def _args(inputs, conv, dtype):
    r, k, v, lw, u, s0 = inputs
    return (conv(r, dtype), conv(k, dtype), conv(v, dtype), conv(lw),
            conv(u), conv(s0))


@pytest.mark.parametrize("B,H,S,D,chunk,dtype,with_s0", CASES)
def test_ref_matches_jax_ref(B, H, S, D, chunk, dtype, with_s0):
    inputs = _inputs(B, H, S, D, dtype, with_s0)
    want_y, want_s = jax_ref(*_args(inputs, _j, dtype))
    got_y, got_s = rwkv6_scan_ref(*_args(inputs, _t, dtype))
    assert got_y.dtype == torch.float32 and got_y.shape == (B, H, S, D)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("B,H,S,D,chunk,dtype,with_s0", CASES)
def test_ops_match_jax_xla_and_pallas_interpret(B, H, S, D, chunk, dtype,
                                                with_s0, impl):
    inputs = _inputs(B, H, S, D, dtype, with_s0, seed=1)
    got_y, got_s = ops.rwkv6_scan(*_args(inputs, _t, dtype), impl=impl)
    for jimpl, kw in (("xla", {}), ("pallas_interpret", {"chunk": chunk})):
        want_y, want_s = jax_rwkv6_scan(*_args(inputs, _j, dtype),
                                        impl=jimpl, **kw)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_adapter_matches_the_reference_adapter(impl):
    """Model layout (B, S, H, D) in and out, a state or None."""
    B, H, S, D = 2, 4, 45, 32
    r, k, v, lw, u, s0 = _inputs(B, H, S, D, "float32", True, seed=3)
    ml = lambda a: np.ascontiguousarray(np.moveaxis(a, 2, 1))  # noqa: E731
    fn = ops.wkv_kernel_adapter(impl)
    jfn = jax_wkv_adapter("pallas_interpret", chunk=16)
    for state in (s0, None):
        got_y, got_s = fn(_t(ml(r)), _t(ml(k)), _t(ml(v)), _t(ml(lw)),
                          _t(u), _t(state))
        js = jnp.zeros((B, H, D, D)) if state is None else _j(state)
        want_y, want_s = jfn(_j(ml(r)), _j(ml(k)), _j(ml(v)), _j(ml(lw)),
                             _j(u), js)
        assert got_y.shape == (B, S, H, D)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_carried_state_splits_the_scan():
    r, k, v, lw, u, s0 = (_t(a) for a in _inputs(1, 2, 90, 32, "float32",
                                                 True, seed=4))
    full_y, full_s = ops.rwkv6_scan(r, k, v, lw, u, s0)
    h = 41
    y1, s1 = ops.rwkv6_scan(r[:, :, :h], k[:, :, :h], v[:, :, :h],
                            lw[:, :, :h], u, s0)
    y2, s2 = ops.rwkv6_scan(r[:, :, h:], k[:, :, h:], v[:, :, h:],
                            lw[:, :, h:], u, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 2).numpy(),
                               full_y.numpy(), **TOL)
    np.testing.assert_allclose(s2.numpy(), full_s.numpy(), **TOL)


@pytest.mark.parametrize("S", [32, 100])
def test_adapter_plugs_into_time_mix(S):
    """The port's ``time_mix`` with the adapter against the reference's
    with its own (the Pallas kernel in interpret mode), from the
    reference's parameters with every zero-initialised leaf (decay base,
    bonus, mixes, LoRA up-projections) drawn non-zero."""
    rcfg = ref_get_config("rwkv6-7b").reduced()
    rparams = ref_build_model(rcfg).init(jax.random.key(0))
    rng = np.random.RandomState(5)
    p = {k: np.asarray(v[0]) + (rng.randn(*v.shape[1:]) * 0.2
                                if not np.asarray(v).any() else 0)
         for k, v in rparams["blocks"]["rwkv"].items()}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    x = rng.randn(2, S, rcfg.d_model).astype(np.float32)
    want, want_s = RR.time_mix({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), rcfg, None,
                               kernel=jax_wkv_adapter(chunk=16))
    got, got_s = R.time_mix({k: _t(v) for k, v in p.items()}, _t(x),
                            get_config("rwkv6-7b").reduced(), None,
                            kernel=ops.wkv_kernel_adapter())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **MIX_TOL)


def test_wrapper_contract():
    r, k, v, lw, u, _ = (_t(a) for a in _inputs(1, 2, 8, 32, "float32",
                                                False))
    with pytest.raises(ValueError, match="impl"):
        ops.rwkv6_scan(r, k, v, lw, u, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.wkv_kernel_adapter("xla")
    with pytest.raises(ValueError, match="CUDA"):
        K.rwkv6_scan_cuda(r, k, v, lw, u)
    before = K.launches.count
    ops.rwkv6_scan(r, k, v, lw, u)                 # CPU: the plain version
    assert K.launches.count == before


def test_every_rwkv_config_has_a_kernel_variant():
    for cfg in (get_config("rwkv6-7b"), get_config("rwkv6-7b").reduced()):
        assert cfg.rwkv.head_dim in K.HEAD_DIMS, cfg.name


# One SM: 228 KB of shared memory, of which each resident block reserves
# 1 KB; one block may use at most 227 KB, static shared memory 48 KB
# (H100)
SM_SMEM, BLOCK_RESERVED, BLOCK_SMEM_MAX = 233_472, 1024, 232_448


@pytest.mark.parametrize("dtype,variant", [(torch.float32, "simt"),
                                           (torch.bfloat16, "mma")])
def test_the_variant_follows_the_dtype(dtype, variant):
    """fp32 r, k and v launch the SIMT kernel, bf16 the tensor-core one;
    the launch counter counts each, and a CPU call counts neither."""
    assert K.VARIANTS[dtype] == variant
    assert set(K.launches.by_variant) == {"mma", "simt"}
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    r, k, v, lw, u, _ = _inputs(1, 2, 40, 32, name, False)
    before = (K.launches.count, dict(K.launches.by_variant))
    ops.rwkv6_scan(_t(r, name), _t(k, name), _t(v, name), _t(lw), _t(u))
    assert (K.launches.count, dict(K.launches.by_variant)) == before


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", K.HEAD_DIMS)
def test_each_variant_fits_the_sm(D, w_dtype):
    """Shared memory and grid of both variants at every compiled D and
    logw dtype: the SIMT variant's static arrays within 48 KB, the mma
    variant's within a block's 227 KB and four blocks an SM; the mma
    variant two blocks (one cluster) of 128 threads a (batch, head)."""
    simt = K.smem_bytes("simt", D, w_dtype)
    mma = K.smem_bytes("mma", D, w_dtype)
    assert 0 < simt <= 48 * 1024 and 0 < mma <= BLOCK_SMEM_MAX
    assert 4 * (mma + BLOCK_RESERVED) <= SM_SMEM
    B, H = 4, 64                                     # rwkv6-7b's prefill
    assert K.launch_shape("simt", B, H, D) == ((H, B), D)
    assert K.launch_shape("mma", B, H, D) == ((2 * H, B), 128)
    assert (2 * H) * B > B * H                       # more blocks than B H
