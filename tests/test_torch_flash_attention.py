"""The port's flash attention against the JAX reference, on the CPU.

On the same numpy inputs:

* the plain version (``attention_ref``, and ``flash_attention`` under
  both impls, which on CPU tensors take the plain version) against JAX's
  ``attention_ref``: causal, sliding window, ``q_offset``, GQA groups 1, 2
  and 7, head_dim 32, 64, 80 and 192, ragged Sq and Sk, fp32 and bf16, rows that
  see no key;
* the same against the Pallas kernel run in interpret mode
  (``flash_attention(impl="pallas_interpret")``), where the two agree by
  contract (the Pallas wrapper pads keys with zeros and relies on the
  causal mask to hide them; the port masks them, so a query past the last
  key differs by design and is left out);
* the model-layout adapter against the reference's, and the wrapper's
  contract: the non-causal ragged ``ValueError``, unknown impls, the CUDA
  wrapper refusing CPU tensors.

The CUDA kernel itself is held to its plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as RefOps
from repro.kernels.flash_attention.ref import attention_ref as jax_ref

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref

# fp32: both sides compute in fp32 and differ in summation order only.
# bf16: both read the same bf16 inputs, compute in fp32 and round once to
# bf16, so they differ by at most one bf16 ulp, 2^-7 of the value
F32_RTOL, F32_ATOL = 1e-5, 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-6

# (B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset)
SWEEP = [
    (1, 2, 2, 64, 64, 64, True, None, 0),       # group 1, aligned
    (2, 4, 2, 100, 100, 64, True, None, 0),     # group 2, ragged
    (1, 7, 1, 77, 77, 80, True, None, 0),       # group 7, D 80
    (2, 4, 2, 128, 128, 64, True, 16, 0),       # window
    (1, 14, 2, 45, 131, 80, True, 40, 86),      # q_offset, Sq < Sk, window
    (1, 4, 4, 33, 97, 64, True, None, 64),      # q_offset, ragged
    (2, 4, 2, 96, 96, 64, False, None, 0),      # non-causal
    (1, 4, 2, 70, 64, 80, False, 24, 30),       # non-causal window
    (2, 8, 4, 64, 64, 32, True, None, 0),       # D 32 (flude-paper)
    (1, 6, 2, 40, 40, 192, True, None, 0),      # D 192 (nemotron-4-340b)
]


def _inputs(B, Hq, Hkv, Sq, Sk, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Hq, Sq, D).astype(np.float32),
            rng.randn(B, Hkv, Sk, D).astype(np.float32),
            rng.randn(B, Hkv, Sk, D).astype(np.float32))


def _jax(x, dtype):
    return jnp.asarray(x, jnp.float32).astype(dtype)


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _close(got, want, dtype):
    tol = (dict(rtol=BF16_RTOL, atol=BF16_ATOL) if dtype == "bfloat16"
           else dict(rtol=F32_RTOL, atol=F32_ATOL))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,q_offset", SWEEP)
def test_plain_matches_jax_reference(B, Hq, Hkv, Sq, Sk, D, causal, window,
                                     q_offset, dtype):
    q, k, v = _inputs(B, Hq, Hkv, Sq, Sk, D, seed=Sq + Sk + D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = jax_ref(_jax(q, jd), _jax(k, jd), _jax(v, jd), **kw)
    got = attention_ref(_torch(q, td), _torch(k, td), _torch(v, td), **kw)
    assert got.dtype == td and tuple(got.shape) == want.shape
    _close(got, want, dtype)
    # impl="torch" is the plain version; impl="cuda" on CPU tensors too
    for impl in ("torch", "cuda"):
        if impl == "cuda" and not causal and Sk % min(128, Sk):
            continue                     # the reference's ValueError
        assert torch.equal(ops.flash_attention(
            _torch(q, td), _torch(k, td), _torch(v, td), impl=impl, **kw),
            got)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window,q_offset", [
    (1, 2, 2, 128, 64, True, None, 0),
    (2, 4, 2, 100, 64, True, None, 0),          # ragged: padded keys
    (1, 7, 1, 64, 80, True, 16, 0),              # D 80 padded to 128
    (1, 4, 2, 128, 64, False, None, 0),
    (1, 4, 2, 128, 64, True, 32, 0),
])
def test_plain_matches_pallas_interpret(B, Hq, Hkv, S, D, causal, window,
                                        q_offset):
    q, k, v = _inputs(B, Hq, Hkv, S, S, D, seed=S + D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = RefOps.flash_attention(_jax(q, jnp.float32), _jax(k, jnp.float32),
                                  _jax(v, jnp.float32), block_q=64,
                                  block_k=64, impl="pallas_interpret", **kw)
    got = ops.flash_attention(_torch(q, torch.float32),
                              _torch(k, torch.float32),
                              _torch(v, torch.float32), block_k=64,
                              **kw)
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_without_a_visible_key_average_v(dtype):
    """Non-causal with a window, past the keys: row i (position 25 + i)
    sees keys 16 + i .. 29, so rows 0..13 see keys and rows 14.. none;
    those (finite NEG_INF) average V over every key."""
    B, Hq, Hkv, Sq, Sk, D = 1, 4, 2, 40, 30, 64
    q, k, v = _inputs(B, Hq, Hkv, Sq, Sk, D, seed=5)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(causal=False, window=10, q_offset=25)
    want = jax_ref(_jax(q, jd), _jax(k, jd), _jax(v, jd), **kw)
    got = attention_ref(_torch(q, td), _torch(k, td), _torch(v, td), **kw)
    _close(got, want, dtype)
    mean_v = _torch(v, td).float().mean(2).repeat_interleave(2, dim=1)
    empty = got[:, :, 14:]
    np.testing.assert_allclose(
        empty.float().numpy(),
        mean_v[:, :, None].expand_as(empty).numpy(),
        **(dict(rtol=BF16_RTOL, atol=BF16_ATOL) if dtype == "bfloat16"
           else dict(rtol=F32_RTOL, atol=F32_ATOL)))


def test_model_layout_matches_reference():
    B, S, Hk, G, D = 2, 50, 2, 3, 64
    rng = np.random.RandomState(3)
    q = rng.randn(B, S, Hk, G, D).astype(np.float32)
    k = rng.randn(B, S, Hk, D).astype(np.float32)
    v = rng.randn(B, S, Hk, D).astype(np.float32)
    for window in (None, 8):
        want = RefOps.flash_attention_model_layout(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            window=window, impl="xla")
        got = ops.flash_attention_model_layout(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=True, window=window)
        assert tuple(got.shape) == (B, S, Hk, G, D)
        _close(got, want, "float32")


def test_non_causal_ragged_keys_are_refused_like_the_reference():
    q, k, v = (_torch(x, torch.float32)
               for x in _inputs(1, 2, 2, 64, 100, 64, seed=1))
    with pytest.raises(ValueError, match="non-causal"):
        RefOps.flash_attention(_jax(q.numpy(), jnp.float32),
                               _jax(k.numpy(), jnp.float32),
                               _jax(v.numpy(), jnp.float32), causal=False,
                               block_k=64, impl="pallas_interpret")
    with pytest.raises(ValueError, match="non-causal"):
        ops.flash_attention(q, k, v, causal=False, block_k=64)
    ops.flash_attention(q, k, v, causal=False, block_k=64, impl="torch")
    ops.flash_attention(q, k, v, causal=False, block_k=50)   # 100 % 50


def test_unknown_impl_and_cpu_tensors_to_the_kernel_raise():
    q, k, v = (_torch(x, torch.float32)
               for x in _inputs(1, 2, 2, 8, 8, 64, seed=2))
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")
    before = K.launches.count
    with pytest.raises(ValueError, match="CUDA device"):
        K.flash_attention_cuda(q, k, v)
    ops.flash_attention(q, k, v, impl="cuda")        # CPU: the plain version
    assert K.launches.count == before
