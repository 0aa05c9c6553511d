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
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as RefOps
from repro.kernels.flash_attention.ref import attention_ref as jax_ref

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref as _ref
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


# ---------------------------------------------------------------------------
# the bf16 kernel's gate, its TMA layout rule and its build report
# ---------------------------------------------------------------------------

def _attention_masked_by_hand(q, k, v, ok, p_bf16=False):
    """fp32 softmax attention of (B, H, Sq, D) inputs (group 1) under the
    boolean mask ``ok`` (Sq, Sk); ``p_bf16`` rounds P to bf16 before P·V,
    as a kernel that carries P in one bf16 term would."""
    s = q.float() @ k.float().transpose(-1, -2) * q.shape[-1] ** -0.5
    p = torch.softmax(torch.where(ok, s, -1e30), -1)
    if p_bf16:
        p = p.to(torch.bfloat16).float()
    return p @ v.float()


def test_bf16_ulp_is_the_step_to_the_next_bf16_value():
    x = torch.from_numpy(np.random.RandomState(5).randn(4096)
                         .astype(np.float32) * 10.0 ** np.arange(-6, 2)
                         .repeat(512)).to(torch.bfloat16).abs()
    x = x[x > 0]
    step = (x.view(torch.int16) + 1).view(torch.bfloat16).float() - x.float()
    assert torch.equal(_ref.bf16_ulp(x), step)
    assert torch.equal(_ref.bf16_ulp(-x), step)
    assert float(_ref.bf16_ulp(torch.zeros(1))) == 0.0
    assert float(_ref.bf16_ulp(torch.ones(1))) == 2.0 ** -7


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0),
                                                    (True, 24, 40),
                                                    (False, 10, 25)])
def test_bf16_gate_passes_the_rounded_truth(causal, window, q_offset):
    """The plain version on bf16 inputs (fp32 inside, one rounding to
    bf16) lies within one ulp of the fp32 truth everywhere, rows that see
    no key included."""
    q, k, v = (_torch(x, torch.bfloat16)
               for x in _inputs(1, 4, 2, 40, 70, 64, seed=11))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    truth = attention_ref(q.float(), k.float(), v.float(), **kw)
    assert _ref.bf16_excess(attention_ref(q, k, v, **kw), truth) <= 0.0
    assert _ref.bf16_excess(truth.to(torch.bfloat16), truth) <= 0.0


def test_bf16_gate_fails_a_skipped_kv_tile():
    """Keys 64..127 left out of every row past them, as a kernel that
    skipped its second tile of 64 keys would: far beyond the floor."""
    q, k, v = (_torch(x, torch.bfloat16)
               for x in _inputs(1, 4, 4, 512, 512, 64, seed=13))
    qp, kp = torch.arange(512)[:, None], torch.arange(512)[None, :]
    causal = kp <= qp
    truth = _attention_masked_by_hand(q, k, v, causal)
    skipped = _attention_masked_by_hand(
        q, k, v, causal & ~((kp >= 64) & (kp < 128) & (qp >= 128)))
    assert _ref.bf16_excess(skipped.to(torch.bfloat16), truth) > 16 * _ref.BF16_FLOOR


def test_bf16_gate_fails_p_in_one_bf16_term():
    """P rounded to bf16 before P·V (one term) moves small outputs by far
    more than their ulp: beyond the floor, which a kernel that carries P
    in two terms stays under."""
    q, k, v = (_torch(x, torch.bfloat16)
               for x in _inputs(1, 4, 4, 1024, 1024, 128, seed=14))
    causal = torch.arange(1024)[None, :] <= torch.arange(1024)[:, None]
    truth = _attention_masked_by_hand(q, k, v, causal)
    one_term = _attention_masked_by_hand(q, k, v, causal, p_bf16=True)
    assert _ref.bf16_excess(one_term.to(torch.bfloat16),
                            truth) > _ref.BF16_FLOOR


def test_tma_layout_accepts_the_model_layout_views():
    """The serve path's (B, S, Hk, G, D) and (B, S, Hk, D) projections,
    read as (B, H, S, D) views, at every head dim."""
    for D in K.HEAD_DIMS:
        q = torch.zeros(2, 50, 2, 3, D, dtype=torch.bfloat16)
        kv = torch.zeros(2, 50, 2, D, dtype=torch.bfloat16)
        qv = q.reshape(2, 50, 6, D).transpose(1, 2)
        for x in (qv, kv.transpose(1, 2), qv.contiguous()):
            assert K.tma_layout_error(tuple(x.shape), x.stride(),
                                      16 * 1000) is None
        # a stride of an axis of length 1 is never used
        assert K.tma_layout_error((1, 6, 50, D), (7, D, 6 * D, 1),
                                  16 * 1000) is None


@pytest.mark.parametrize("shape,strides,ptr,match", [
    ((1, 4, 64, 64), (16384, 4096, 64, 1), 16 * 7 + 2, "16-byte aligned"),
    ((1, 4, 64, 64), (16384, 4096, 64, 1), 8, "16-byte aligned"),
    ((1, 4, 64, 64), (17408, 4352, 68, 1), 0, "multiple of 16"),
    ((2, 4, 64, 64), (3, 4096, 64, 1), 0, "multiple of 16"),
    ((1, 4, 64, 64), (16384, 0, 64, 1), 0, "positive"),
    ((1, 4, 64, 64), (16384, 64, 1, 64), 0, "contiguous"),
    ((2, 2, 64, 64), (2 ** 39, 4096, 64, 1), 0, "below 2"),
])
def test_tma_layout_refuses_what_tma_cannot_read(shape, strides, ptr, match):
    why = K.tma_layout_error(shape, strides, ptr)
    assert why is not None and match.split()[0] in why


def test_kernel_variants_fit_shared_memory():
    """Every variant's dynamic shared memory fits a block's 227 KB."""
    for D in K.HEAD_DIMS:
        for variant in ("simt", "wgmma"):
            assert 0 < K.smem_bytes(variant, D) <= 232_448
    assert K.smem_bytes("wgmma", 128) == 1024 + 32768 + 3 * 32768 + 56


def test_launch_counter_counts_each_variant():
    c = _build.LaunchCounter(variants=("wgmma", "simt"))
    view = c.by_variant
    c.add("wgmma")
    c.add("wgmma")
    c.add("simt")
    assert (c.count, view) == (3, {"wgmma": 2, "simt": 1})
    c.reset()
    assert (c.count, view) == (0, {"wgmma": 0, "simt": 0})
    plain = _build.LaunchCounter()
    plain.add()
    assert (plain.count, plain.by_variant) == (1, {})


PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi128EEEv14CUtensorMap_stS1_S1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115flash_fwd_wgmmaILi128EEEv14CUtensorMap_stS1_S1_NS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas warning : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114flash_fwd_simtILi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114flash_fwd_simtILi64EEEvNS_6ParamsE
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 110 registers, 1024 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_report_is_read_per_kernel():
    got = _build.ptxas_kernels(PTXAS_REPORT)
    wg = "_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi128EEEv14CUtensorMap_stS1_S1_NS_6ParamsE"
    simt = "_ZN12_GLOBAL__N_114flash_fwd_simtILi64EEEvNS_6ParamsE"
    assert got == {wg: _build.KernelReport(168, 0, 0),
                   simt: _build.KernelReport(110, 12, 8)}
    warnings = _build.ptxas_warnings(PTXAS_REPORT)
    assert len(warnings) == 1 and "serialized" in warnings[0]
    # ptxas also reports serialisation as an info line
    info = ("ptxas info    : (C7512) Potential Performance Loss: "
            "wgmma.mma_async instructions are serialized due to "
            "insufficient register resources for the function 'f'")
    assert len(_build.wgmma_serialised(PTXAS_REPORT)) == 1
    assert _build.wgmma_serialised(PTXAS_REPORT + info) == [
        warnings[0], info]


# attention_bwd_ref against jax.grad of the reference's attention_ref: the
# gradients in fp32, differing in summation order only; within 1e-5 of
# max(1, max |g|) of each tensor
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,q_offset", [
    (2, 4, 2, 100, 100, 64, True, None, 0),     # group 2, ragged
    (1, 7, 1, 77, 77, 80, True, None, 0),       # group 7
    (2, 4, 2, 128, 128, 64, True, 16, 0),       # window
    (1, 14, 2, 45, 131, 80, True, 40, 86),      # q_offset, Sq < Sk, window
    (2, 4, 2, 96, 96, 32, False, None, 0),      # non-causal
])
def test_plain_backward_matches_jax_grad(B, Hq, Hkv, Sq, Sk, D, causal,
                                         window, q_offset):
    import jax
    q, k, v = _inputs(B, Hq, Hkv, Sq, Sk, D, seed=Sq + D)
    dout = np.random.RandomState(Sk).randn(B, Hq, Sq, D).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, **kw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    got = _ref.attention_bwd_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                 torch.from_numpy(dout), **kw)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        bound = 1e-5 * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.numpy() - w).max()) <= bound


@pytest.mark.parametrize("Sq,Sk,q_offset,causal,window,empty", [
    (64, 64, 0, True, None, False),
    (64, 64, 0, True, 8, False),          # the window follows the diagonal
    (64, 64, 0, False, None, False),
    (160, 200, 200, False, 30, True),     # rows past Sk + W - 1
    (10, 20, -3, True, None, True),       # causal rows before key 0
    (1, 77, 76, True, None, False),
    (40, 0, 0, True, None, True),         # no keys at all
    (0, 10, 0, True, None, False),
])
def test_rows_without_keys_finds_the_rows_the_backward_refuses(
        Sq, Sk, q_offset, causal, window, empty):
    assert K.rows_without_keys(Sq, Sk, q_offset, causal, window) == empty
    if Sq and Sk:                  # the masks, row by row
        qp = q_offset + torch.arange(Sq)[:, None]
        kp = torch.arange(Sk)[None]
        ok = torch.ones(Sq, Sk, dtype=torch.bool)
        if causal:
            ok &= kp <= qp
        if window is not None:
            ok &= kp > qp - window
        assert bool((~ok.any(1)).any()) == empty


def test_backward_kernels_fit_shared_memory():
    """Every backward kernel's dynamic shared memory fits a block's 227 KB
    at every head dim: the SIMT pair (220,672 bytes at D 192) and the
    wgmma dq and dk/dv kernels (bf16 boxes of 64 columns, 3 stages)."""
    for D in K.HEAD_DIMS:
        assert 0 < K.bwd_smem_bytes(D) <= 232_448
        for kernel in ("wgmma_dq", "wgmma_dkdv"):
            assert 0 < K.bwd_smem_bytes(D, kernel) <= 232_448
    assert K.bwd_smem_bytes(192) == 220_672
    # dq at D 128: Q and dO of 128 rows, 3 stages of K and V of 64 keys
    assert K.bwd_smem_bytes(128, "wgmma_dq") == \
        1024 + 2 * 2 * 128 * 128 + 3 * 2 * 2 * 64 * 128 + 56
    # dk/dv at D 192: K and V of 64 keys, 3 stages of 32-row Q and dO
    assert K.bwd_smem_bytes(192, "wgmma_dkdv") == \
        1024 + 2 * 3 * 64 * 128 + 3 * 2 * 3 * 32 * 128 + 56


@pytest.mark.parametrize("D", K.HEAD_DIMS)
def test_fp32_backward_kernels_fit_shared_memory(D):
    """The fp32 tensor-core kernels hold every tile in three bf16 terms:
    dq's 128-row Q and dO (64 above D 64) and its K and V stages, dk/dv's
    K and V and its Q and dO stages, within a block's 227 KB at every
    head dim, as the source's static_assert holds them."""
    for kernel in ("f32_dq", "f32_dkdv"):
        assert 0 < K.bwd_smem_bytes(D, kernel) <= 232_448
    # D 64: 3 terms of 128-row Q and dO, 2 stages of 64-key K and V
    assert K.bwd_smem_bytes(64, "f32_dq") == \
        1024 + 2 * 3 * 128 * 128 + 2 * 2 * 3 * 64 * 128 + 40
    # D 192: 3 boxes, one stage of 32-row Q and dO beside K and V
    assert K.bwd_smem_bytes(192, "f32_dkdv") == \
        1024 + 2 * 3 * 3 * 64 * 128 + 2 * 3 * 3 * 32 * 128 + 24


def test_cpu_tensors_under_grad_differentiate_the_plain_version():
    """On the CPU ``impl="cuda"`` takes the plain version, so a gradient
    flows by autograd, the same as ``impl="torch"``'s."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs(1, 4, 2, 40, 40, 32, seed=0))
    grads = []
    for impl in ("cuda", "torch"):
        out = ops.flash_attention(q, k, v, impl=impl)
        grads.append(torch.autograd.grad(out.sum(), (q, k, v)))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_attention_bwd_cuda(q, k, v, q, torch.zeros(1, 4, 40), q)


# the one rule every wrapper without a backward kernel keeps under grad
# (kernels/grad.py); it reads only grad mode and requires_grad, so the
# CPU shows it
@pytest.mark.parametrize("grad_mode,requires,refused", [
    (True, (True, False, None), True),     # one input requires grad
    (True, (False, False, None), False),   # none does
    (False, (True, True, None), False),    # under torch.no_grad()
    (True, (None, None, True), True),      # None skipped, the last counts
])
def test_refuse_grad_rule(grad_mode, requires, refused):
    from repro_torch.kernels.grad import needs_grad, refuse_grad
    tensors = [None if r is None else torch.zeros(2, requires_grad=r)
               for r in requires]
    with torch.set_grad_enabled(grad_mode):
        assert needs_grad(*tensors) == refused
        if refused:
            with pytest.raises(NotImplementedError,
                               match=r"ssm_scan cuda: .*Queue A #15g"):
                refuse_grad("ssm_scan cuda", *tensors)
        else:
            refuse_grad("ssm_scan cuda", *tensors)


# ---- bf16 gradients ---------------------------------------------------------
# attention_bwd_ref on bf16 inputs computes in fp32 on the values upcast
# and rounds each gradient once to bf16, as the bf16 backward kernel
# does; against float64 autograd on the same bf16 values, within one bf16
# ulp of the float64 gradient plus the fp32 tolerance above (1e-5 of
# max(1, max |g|))
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,q_offset", [
    (2, 4, 2, 100, 100, 64, True, None, 0),     # group 2, ragged
    (1, 7, 1, 77, 77, 80, True, 16, 0),         # group 7, window
    (1, 14, 2, 45, 131, 128, True, 40, 86),     # q_offset, Sq < Sk
])
def test_plain_backward_in_bf16_matches_float64(B, Hq, Hkv, Sq, Sk, D,
                                                causal, window, q_offset):
    bf16 = torch.bfloat16
    q, k, v = (torch.from_numpy(x).to(bf16)
               for x in _inputs(B, Hq, Hkv, Sq, Sk, D, seed=Sq + D + 3))
    dout = torch.from_numpy(np.random.RandomState(Sk).randn(
        B, Hq, Sq, D).astype(np.float32)).to(bf16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _ref.attention_bwd_ref(q, k, v, dout, **kw)
    want = _ref.attention_bwd_ref(q.double(), k.double(), v.double(),
                                  dout.double(), **kw)
    for g, w in zip(got, want):
        assert g.dtype == bf16 and w.dtype == torch.float64
        err = (g.double() - w).abs() - _ref.bf16_ulp(w)
        assert float(err.max()) <= 1e-5 * max(1.0, float(w.abs().max()))


def test_lse_ref_is_the_log_of_the_softmax_denominator():
    """``attention_lse_ref`` (what the forward kernels write under
    ``with_lse``) is log Σ exp over each row's visible scaled scores:
    exp(S - lse) is the plain softmax."""
    q, k, v = (torch.from_numpy(x).double()
               for x in _inputs(1, 4, 2, 40, 60, 32, seed=2))
    kw = dict(causal=True, window=24, q_offset=20)
    lse = _ref.attention_lse_ref(q, k, **kw)
    assert lse.shape == (1, 4, 40) and lse.dtype == torch.float64
    s = _ref._masked_scores(q, k, True, 24, None, 20).reshape(1, 4, 40, 60)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.repeat_interleave(2, 1))
    assert torch.allclose(o, attention_ref(q, k, v, **kw), atol=1e-12)


def test_function_plumbing_in_bf16(monkeypatch):
    """``FlashAttentionFn`` on bf16 q, k and v, the launches replaced by
    CPU stand-ins with the kernels' contracts: the forward is asked for
    the lse, the backward gets the saved bf16 tensors, that lse and a
    bf16 output gradient, and the gradients come back bf16, equal to the
    plain backward's (each rounded once from fp32)."""
    seen = {}

    def fwd(q, k, v, with_lse=False, **kw):
        seen["fwd"] = (q.dtype, with_lse)
        o = attention_ref(q, k, v, **kw)
        return (o, _ref.attention_lse_ref(q, k, **kw)) if with_lse else o

    def bwd(q, k, v, out, lse, dout, **kw):
        seen["bwd"] = (q.dtype, out.dtype, lse.dtype, dout.dtype,
                       dout.is_contiguous())
        return _ref.attention_bwd_ref(q, k, v, dout, **kw)
    monkeypatch.setattr(ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", bwd)
    bf16 = torch.bfloat16
    q, k, v = (torch.from_numpy(x).to(bf16).requires_grad_(True)
               for x in _inputs(2, 4, 2, 50, 50, 64, seed=9))
    dout = torch.from_numpy(np.random.RandomState(9).randn(
        2, 4, 50, 64).astype(np.float32)).to(bf16)
    kw = dict(causal=True, window=20, q_offset=0)
    out = ops.FlashAttentionFn.apply(q, k, v, True, 20, None, 0)
    got = torch.autograd.grad(out, (q, k, v), dout.transpose(2, 3)
                              .contiguous().transpose(2, 3))
    assert seen == {"fwd": (bf16, True),
                    "bwd": (bf16, bf16, torch.float32, bf16, True)}
    want = _ref.attention_bwd_ref(q, k, v, dout, **kw)
    assert all(g.dtype == bf16 and torch.equal(g, w)
               for g, w in zip(got, want))


# ---- the tensor-core bf16 backward (flash_bwd_wgmma) ------------------------
# Its rounding points mirrored on the CPU (ref.attention_bwd_wgmma_mirror:
# S and dP from the bf16 values with fp32 sums, P and dS rounded to bf16
# terms before the products, which run in float64, each gradient rounded
# to bf16 once) against float64 autograd on the same bf16 values, under
# the gate the card holds the kernel to (ref.bf16_grad_gate with the fp32
# kernel's 1e-4): two terms pass, one term fails
MIRROR_SHAPES = [
    # (B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset)
    (1, 2, 2, 128, 128, 64, True, None, 0),     # the training structure
    (1, 7, 1, 256, 256, 128, True, None, 0),    # group 7, Qwen2's D
    (1, 7, 1, 130, 190, 64, True, 50, 60),      # window 50, q_offset 60
    (1, 4, 2, 65, 128, 80, False, None, 0),     # D 80, non-causal
]
FLASH_BWD_TOL = 1e-4


def _mirror_case(B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset):
    bf16 = torch.bfloat16
    q, k, v = (torch.from_numpy(x).to(bf16)
               for x in _inputs(B, Hq, Hkv, Sq, Sk, D, seed=Sq + D + 5))
    dout = torch.from_numpy(np.random.RandomState(Sk + 1).randn(
        B, Hq, Sq, D).astype(np.float32)).to(bf16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _ref.attention_bwd_ref(q.double(), k.double(), v.double(),
                                  dout.double(), **kw)
    return q, k, v, dout, kw, want


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,q_offset",
                         MIRROR_SHAPES)
def test_bf16_backward_mirror_in_two_terms_passes_the_gate(
        B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset):
    q, k, v, dout, kw, want = _mirror_case(B, Hq, Hkv, Sq, Sk, D, causal,
                                           window, q_offset)
    got = _ref.attention_bwd_wgmma_mirror(q, k, v, dout, terms=2, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        exc, top, ok = _ref.bf16_grad_gate(g, w, FLASH_BWD_TOL)
        assert ok, (exc, top)
        # with room to spare: under 1e-5 of max(1, max |g|)
        assert exc <= 1e-5 * max(1.0, top)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,q_offset",
                         MIRROR_SHAPES)
def test_bf16_backward_mirror_in_one_term_fails_the_gate(
        B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset):
    """P and dS in one bf16 term each, as a kernel that dropped the low
    term would carry them: some gradient fails the gate's own-max part
    (1e-3 of max |g|)."""
    q, k, v, dout, kw, want = _mirror_case(B, Hq, Hkv, Sq, Sk, D, causal,
                                           window, q_offset)
    got = _ref.attention_bwd_wgmma_mirror(q, k, v, dout, terms=1, **kw)
    gates = [_ref.bf16_grad_gate(g, w, FLASH_BWD_TOL)
             for g, w in zip(got, want)]
    assert not all(ok for _, _, ok in gates), gates


# The fp32 tensor-core backward's rounding mirrored on the CPU
# (ref.attention_bwd_f32_mirror: every fp32 factor in bf16 terms, the term
# products with i + j <= terms - 1 summed as the card's tensor cores sum
# them, in tiles, P and delta from the kernel's own scores), held to a
# float64 truth on the same fp32 inputs against the plain fp32
# attention's distance: the
# rule chip_smoke.py's flash_f64_distances holds the kernel to on the
# card, each of dq, dk and dv no more than 2x as far as plain fp32's.
# Three terms pass it (0.2-1.1x here), two fail it (7-60x)
F32_MIRROR_SHAPES = [
    # (B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset)
    (1, 2, 2, 128, 128, 64, True, None, 0),     # causal
    (2, 6, 2, 128, 128, 64, True, None, 0),     # 100m's GQA, group 3
    (1, 4, 4, 256, 256, 64, True, 64, 0),       # window 64
    (1, 7, 1, 130, 190, 64, True, 50, 60),      # group 7, q_offset 60
    (2, 4, 2, 128, 128, 32, True, None, 0),     # flude-paper's D 32
    (1, 4, 2, 65, 128, 80, False, None, 0),     # D 80, non-causal
]


@contextlib.contextmanager
def _one_thread():
    """The mirror's many small float64 products on one thread: under a
    loaded machine (the suite's parallel workers) a thread pool's waits
    make each of them orders of magnitude slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _f64_share(x, truth):
    return float((x.double() - truth).abs().max()) / max(
        1.0, float(truth.abs().max()))


def _f32_mirror_ratios(B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset,
                       terms):
    """dq, dk and dv of the mirror in ``terms`` terms: each one's float64
    distance over the plain fp32 attention's."""
    q, k, v = (torch.from_numpy(x)
               for x in _inputs(B, Hq, Hkv, Sq, Sk, D, seed=Sq + D + 5))
    dout = torch.from_numpy(np.random.RandomState(Sk + 1).randn(
        B, Hq, Sq, D).astype(np.float32))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    with _one_thread():
        truth = _ref.attention_bwd_ref(q.double(), k.double(), v.double(),
                                       dout.double(), **kw)
        plain = _ref.attention_bwd_ref(q, k, v, dout, **kw)
        got = _ref.attention_bwd_f32_mirror(q, k, v, dout, terms=terms,
                                            **kw)
    for g in got:
        assert g.dtype == torch.float32
    return [_f64_share(g, t) / _f64_share(p, t)
            for g, p, t in zip(got, plain, truth)]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,q_offset",
                         F32_MIRROR_SHAPES)
def test_fp32_backward_mirror_in_three_terms_is_within_2x_of_plain(
        B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset):
    ratios = _f32_mirror_ratios(B, Hq, Hkv, Sq, Sk, D, causal, window,
                                q_offset, terms=3)
    assert max(ratios) <= 2.0, ratios


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,q_offset",
                         F32_MIRROR_SHAPES)
def test_fp32_backward_mirror_in_two_terms_fails_the_2x_rule(
        B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset):
    """hi + lo of each fp32 factor (2^-17 of it) is not fp32: every
    gradient lands several times as far from float64 as plain fp32's."""
    ratios = _f32_mirror_ratios(B, Hq, Hkv, Sq, Sk, D, causal, window,
                                q_offset, terms=2)
    assert min(ratios) > 2.0, ratios


def test_tensor_core_sums_are_kept_short():
    """``ref._tc_product`` models the card's tensor cores, which truncate
    each wgmma's sum to fp32: run through one accumulator over K = 2048,
    the sum drifts toward zero (here more than 4x as far from float64 as
    an fp32 matmul); in the kernel's tiles of 64, each added to an fp32
    sum rounded to nearest, it is no further than the fp32 matmul."""
    rng = np.random.RandomState(12)
    a = torch.from_numpy(rng.rand(16, 2048).astype(np.float32))
    b = torch.from_numpy(rng.rand(2048, 16).astype(np.float32))
    with _one_thread():
        truth = a.double() @ b.double()
        plain = _f64_share(a @ b, truth)
        chained = _f64_share(_ref._tc_product(a, b, 3, 2048), truth)
        tiled = _f64_share(_ref._tc_product(a, b, 3, 64), truth)
    assert chained > 4 * plain
    assert tiled <= plain


def test_bf16_terms_split_fp32_exactly():
    """``ref._bf16_split``: three bf16 terms hold an fp32 value to within
    2^-24 of it (the kernels' split3), two to within 2^-16, one is
    bf16(x); each remainder is exact in fp32."""
    x = torch.from_numpy(np.random.RandomState(7).randn(4096).astype(
        np.float32) * 10.0 ** np.random.RandomState(8).randint(
            -20, 20, size=4096).astype(np.float32))
    for terms, rel in ((1, 2.0 ** -8), (2, 2.0 ** -16), (3, 2.0 ** -24)):
        parts = _ref._bf16_split(x, terms)
        assert len(parts) == terms
        for t in parts:
            assert torch.equal(t, t.to(torch.bfloat16).double())
        err = (sum(parts) - x.double()).abs()
        assert bool((err <= rel * x.double().abs()).all()), terms
    assert torch.equal(_ref._bf16_terms(x, 2), sum(_ref._bf16_split(x, 2)))


def test_function_plumbing_in_fp32_runs_the_wgmma_f32_variant(monkeypatch):
    """``FlashAttentionFn`` on fp32 asks the backward for no variant, so
    the wrapper takes ``BWD_VARIANTS[fp32]``, the tensor-core kernels,
    and counts the call under ``wgmma_f32``: the launch replaced by a CPU
    stand-in with the wrapper's rule and count, returning the mirror of
    the kernel's rounding, which autograd hands back unchanged."""
    seen = {}

    def fwd(q, k, v, with_lse=False, **kw):
        o = attention_ref(q, k, v, **kw)
        return (o, _ref.attention_lse_ref(q, k, **kw)) if with_lse else o

    def bwd(q, k, v, out, lse, dout, variant=None, **kw):
        seen["asked"] = variant
        K.bwd_launches.add(K.bwd_variant(q.dtype, variant))
        seen["grads"] = _ref.attention_bwd_f32_mirror(q, k, v, dout, **kw)
        return seen["grads"]
    monkeypatch.setattr(ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", bwd)
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs(1, 6, 2, 50, 50, 64, seed=11))
    dout = torch.from_numpy(np.random.RandomState(11).randn(
        1, 6, 50, 64).astype(np.float32))
    before = dict(K.bwd_launches.by_variant)
    with _one_thread():
        out = ops.FlashAttentionFn.apply(q, k, v, True, None, None, 0)
        got = torch.autograd.grad(out, (q, k, v), dout)
    ran = {n: c - before[n] for n, c in K.bwd_launches.by_variant.items()}
    assert seen["asked"] is None
    assert ran == {"wgmma_f32": 1, "simt": 0, "wgmma_bf16": 0,
                   "simt_bf16": 0}
    for g, m in zip(got, seen["grads"]):
        assert g.dtype == torch.float32 and torch.equal(g, m)
    want = _ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(), dout)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * max(1.0, float(
            w.abs().max()))


def test_bf16_grad_gate_is_the_one_rule():
    """``ref.bf16_grad_gate``: the excess beyond one bf16 ulp of the truth
    within tol of max(1, max |truth|) and within 1e-3 of max |truth|; a
    zero gradient against a non-zero truth fails, fp32 outputs are held
    without the ulp."""
    w = torch.tensor([0.5, -0.25, 2.0 ** -10])
    g = w.to(torch.bfloat16)
    assert _ref.bf16_grad_gate(g, w, 1e-4) == (0.0, 0.5, True)
    assert not _ref.bf16_grad_gate(torch.zeros_like(g), w, 1e-4)[2]
    off = (w + torch.tensor([0.0, 0.0, 1e-3])).to(torch.bfloat16)
    exc, top, ok = _ref.bf16_grad_gate(off, w, 1e-4)
    assert not ok and exc > 1e-4
    # fp32 outputs: |got - want| itself (w + 1e-6 rounds to fp32)
    assert _ref.bf16_grad_excess(w + 1e-6, w) == pytest.approx(1e-6,
                                                               rel=0.05)
    assert _ref.BF16_BWD_OWN_TOL == 1e-3


def test_bwd_variant_rule():
    """Both dtypes run the tensor-core backward unless the SIMT one of
    their dtype is named."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert K.BWD_VARIANTS == {f32: "wgmma_f32", bf16: "wgmma_bf16"}
    assert K.bwd_variant(bf16) == "wgmma_bf16"
    assert K.bwd_variant(bf16, "simt_bf16") == "simt_bf16"
    assert K.bwd_variant(f32) == "wgmma_f32"
    assert K.bwd_variant(f32, "simt") == "simt"
    for dtype, variant in ((bf16, "simt"), (f32, "wgmma_bf16"),
                           (f32, "simt_bf16"), (bf16, "mma"),
                           (bf16, "wgmma_f32")):
        with pytest.raises(ValueError, match="variant"):
            K.bwd_variant(dtype, variant)
    with pytest.raises(TypeError):
        K.bwd_variant(torch.float16)
    assert set(K.bwd_launches.by_variant) == {"wgmma_f32", "simt",
                                              "wgmma_bf16", "simt_bf16"}


def test_function_plumbing_in_bf16_runs_the_wgmma_variant(monkeypatch):
    """``FlashAttentionFn`` on bf16 asks the backward for no variant, so
    the wrapper takes ``BWD_VARIANTS[bf16]``, the tensor-core kernels,
    and counts the call under ``wgmma_bf16``: the launch replaced by a
    CPU stand-in with the wrapper's rule and count, returning the mirror
    of the kernel's rounding."""
    seen = {}

    def fwd(q, k, v, with_lse=False, **kw):
        o = attention_ref(q, k, v, **kw)
        return (o, _ref.attention_lse_ref(q, k, **kw)) if with_lse else o

    def bwd(q, k, v, out, lse, dout, variant=None, **kw):
        seen["asked"] = variant
        ran = K.bwd_variant(q.dtype, variant)
        K.bwd_launches.add(ran)
        return _ref.attention_bwd_wgmma_mirror(q, k, v, dout, **kw)
    monkeypatch.setattr(ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", bwd)
    bf16 = torch.bfloat16
    q, k, v = (torch.from_numpy(x).to(bf16).requires_grad_(True)
               for x in _inputs(1, 4, 2, 50, 50, 64, seed=10))
    dout = torch.from_numpy(np.random.RandomState(10).randn(
        1, 4, 50, 64).astype(np.float32)).to(bf16)
    before = dict(K.bwd_launches.by_variant)
    out = ops.FlashAttentionFn.apply(q, k, v, True, None, None, 0)
    got = torch.autograd.grad(out, (q, k, v), dout)
    ran = {n: c - before[n] for n, c in K.bwd_launches.by_variant.items()}
    assert seen == {"asked": None}
    assert ran == {"wgmma_f32": 0, "simt": 0, "wgmma_bf16": 1,
                   "simt_bf16": 0}
    want = _ref.attention_bwd_ref(q.double(), k.double(), v.double(),
                                  dout.double())
    for g, w in zip(got, want):
        assert g.dtype == bf16 and _ref.bf16_grad_gate(g, w, 1e-4)[2]


@pytest.mark.parametrize("B,Hq,Hkv,Sk,per_head", [
    (1, 28, 4, 2048, True),      # Qwen2's heads: 128 blocks a group
    (1, 32, 8, 6144, False),     # Danube's: 768
    (32, 32, 32, 128, False),    # zamba2-1.2b's training: G = 1
    (4, 16, 4, 1024, True),      # 256 blocks, under two waves
    (4, 16, 4, 2048, False),     # 512
])
def test_per_head_blocks_under_two_waves(B, Hq, Hkv, Sk, per_head):
    assert K.per_head_blocks(B, Hq, Hkv, Sk) == per_head


@pytest.mark.parametrize("B,Hq,Hkv,Sk,per_head", [
    (32, 8, 4, 128, False),      # flude-paper training: 256 blocks
    (32, 12, 4, 128, False),     # 100m training: 256
    (8, 12, 4, 2048, False),     # 100m S 2048: 1024
    (1, 12, 4, 2048, True),      # 128 blocks, under one wave
    (1, 12, 12, 2048, False),    # G = 1
])
def test_fp32_per_head_blocks_under_one_wave(B, Hq, Hkv, Sk, per_head):
    assert K.per_head_blocks(B, Hq, Hkv, Sk, torch.float32) == per_head


def test_group_partials_sum_in_a_fixed_order():
    """``sum_group_partials``: the per-query-head fp32 dK (or dV) of each
    group summed over its G heads in fp32, equal to the float64 sum
    within fp32 rounding (G - 1 additions of 2^-24 each, of the sum of
    |x|), the same bits on every call, and rounded to bf16 once by the
    wrapper's copy."""
    torch.set_num_threads(1)
    B, Hkv, G, Sk, D = 2, 4, 7, 130, 64
    part = torch.from_numpy(np.random.RandomState(3).randn(
        B, Hkv * G, Sk, D).astype(np.float32) * 10.0 ** np.random.RandomState(
            4).randint(-3, 3, size=(1, Hkv * G, 1, 1)).astype(np.float32))
    got = K.sum_group_partials(part, Hkv)
    assert got.shape == (B, Hkv, Sk, D) and got.dtype == torch.float32
    f64 = part.double().view(B, Hkv, G, Sk, D)
    bound = (G - 1) * 2.0 ** -24 * f64.abs().sum(2)
    assert bool(((got.double() - f64.sum(2)).abs() <= bound).all())
    assert torch.equal(got, K.sum_group_partials(part.clone(), Hkv))
    # the group's heads are hk * G + g, as the forward orders them
    lone = torch.zeros_like(part)
    lone[:, 3 * G + 5] = 1.0
    assert torch.equal(K.sum_group_partials(lone, Hkv)[:, 3],
                       torch.ones(B, Sk, D))
    assert float(K.sum_group_partials(lone, Hkv)[:, :3].abs().sum()) == 0.0
    dk = torch.empty(B, Hkv, Sk, D, dtype=torch.bfloat16)
    dk.copy_(got)
    assert torch.equal(dk, got.to(torch.bfloat16))
