"""The port's Mamba2 SSD scan against the JAX reference, on the CPU.

On the same numpy inputs (fp32 unless a case says bf16):

* the port's per-step oracle ``ssm_scan_ref`` (kernel layout, groups
  expanded) against JAX's ``ssm_scan_ref``;
* ``ops.ssm_scan`` in the model layout under ``impl="torch"`` and
  ``impl="cuda"`` (a CPU tensor takes the plain version) against JAX's
  ``ssm_scan`` under ``impl="xla"`` (its per-step oracle) and
  ``impl="pallas_interpret"`` (the Pallas kernel's chunked form, run in
  interpret mode): ragged S, groups 1 and 2, P 32 / 64 with N 16 / 64;
* a carried h0: two calls over the halves of S equal one call over all of
  it, on both sides;
* the wrapper's contract: unknown impls, the CUDA wrapper refusing CPU
  tensors.

The CUDA kernel itself is held to ``ssm_scan_ref`` on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_scan_ref

from repro_torch.kernels.ssm_scan import kernel as K
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

# Per-step forms on both sides: fp32, other summation order in the
# einsums only.  Against the Pallas kernel's chunked form: exp(seg_i -
# seg_l) of a within-chunk cumsum against a product of per-step exps, a
# few ulps of the decay per step (2.5e-5 of max(1, |y|) measured at S 4096,
# P = N = 64, chunk 64)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK_TOL = dict(rtol=2e-4, atol=2e-4)

# (B, S, H, P, N, G, chunk, dtype)
CASES = [
    (2, 64, 4, 32, 16, 2, 16, "float32"),     # reduced zamba2 heads, G 2
    (1, 100, 2, 32, 16, 1, 32, "float32"),    # ragged S
    (2, 96, 2, 64, 64, 1, 64, "float32"),     # full-width heads
    (1, 77, 4, 64, 16, 2, 32, "float32"),     # ragged, P 64 / N 16
    (1, 50, 2, 32, 64, 2, 16, "float32"),     # P 32 / N 64
    (1, 64, 2, 32, 16, 2, 32, "bfloat16"),    # bf16 x, B, C
]


def _inputs(B, S, H, P, N, G, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P).astype(np.float32)
    dt = (rng.rand(B, S, H) * 0.5).astype(np.float32)
    A = (-rng.rand(H) - 0.1).astype(np.float32)
    Bm = rng.randn(B, S, G, N).astype(np.float32)
    Cm = rng.randn(B, S, G, N).astype(np.float32)
    if dtype == "bfloat16":     # one rounding, the same bits on both sides
        x, Bm, Cm = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                     for a in (x, Bm, Cm))
    return x, dt, A, Bm, Cm


def _t(a, dtype="float32"):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _j(a, dtype="float32"):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else
                       jnp.float32)


@pytest.mark.parametrize("B,S,H,P,N,G,chunk,dtype", CASES)
def test_ref_matches_jax_ref(B, S, H, P, N, G, chunk, dtype):
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, N, G, dtype)
    rep = H // G
    kl = lambda a: np.moveaxis(a, 1, 2)        # noqa: E731  (B,H,S,…)
    Bk = np.repeat(kl(Bm), rep, axis=1)
    Ck = np.repeat(kl(Cm), rep, axis=1)
    want_y, want_h = jax_ssm_scan_ref(_j(kl(x), dtype), _j(kl(dt)), _j(A),
                                      _j(Bk, dtype), _j(Ck, dtype))
    got_y, got_h = ssm_scan_ref(_t(kl(x), dtype), _t(kl(dt)), _t(A),
                                _t(Bk, dtype), _t(Ck, dtype))
    assert got_y.dtype == torch.float32 and got_y.shape == (B, H, S, P)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               **STEP_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               **STEP_TOL)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("B,S,H,P,N,G,chunk,dtype", CASES)
def test_ops_match_jax_xla_and_pallas_interpret(B, S, H, P, N, G, chunk,
                                                dtype, impl):
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, N, G, dtype, seed=1)
    got_y, got_h = ops.ssm_scan(_t(x, dtype), _t(dt), _t(A), _t(Bm, dtype),
                                _t(Cm, dtype), impl=impl)
    assert got_y.shape == (B, S, H, P) and got_h.shape == (B, H, P, N)
    jargs = (_j(x, dtype), _j(dt), _j(A), _j(Bm, dtype), _j(Cm, dtype))
    xla_y, xla_h = jax_ssm_scan(*jargs, impl="xla")
    np.testing.assert_allclose(got_y.numpy(), np.asarray(xla_y), **STEP_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(xla_h), **STEP_TOL)
    pal_y, pal_h = jax_ssm_scan(*jargs, impl="pallas_interpret",
                                chunk=chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(pal_y),
                               **CHUNK_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(pal_h),
                               **CHUNK_TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_carried_state_splits_the_scan(G):
    """Two calls over the halves of S, the second from the first's final
    state, give one call's output, on the port and on the reference."""
    B, S, H, P, N = 1, 70, 4, 32, 16
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, N, G, "float32", seed=2)
    h = 33
    full_y, full_h = ops.ssm_scan(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm))
    y1, h1 = ops.ssm_scan(_t(x[:, :h]), _t(dt[:, :h]), _t(A),
                          _t(Bm[:, :h]), _t(Cm[:, :h]))
    y2, h2 = ops.ssm_scan(_t(x[:, h:]), _t(dt[:, h:]), _t(A),
                          _t(Bm[:, h:]), _t(Cm[:, h:]), h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               full_y.numpy(), **STEP_TOL)
    np.testing.assert_allclose(h2.numpy(), full_h.numpy(), **STEP_TOL)
    # the reference from the port's carried state
    ry, rh = jax_ssm_scan(_j(x[:, h:]), _j(dt[:, h:]), _j(A),
                          _j(Bm[:, h:]), _j(Cm[:, h:]), h0=_j(h1.numpy()),
                          impl="pallas_interpret", chunk=16)
    np.testing.assert_allclose(y2.numpy(), np.asarray(ry), **CHUNK_TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(rh), **CHUNK_TOL)


def test_empty_sequence_keeps_the_state():
    x, dt, A, Bm, Cm = _inputs(1, 0, 2, 32, 16, 1, "float32")
    h0 = torch.randn(1, 2, 32, 16)
    y, h = ops.ssm_scan(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), h0)
    assert y.shape == (1, 0, 2, 32) and torch.equal(h, h0)


def test_wrapper_contract():
    x, dt, A, Bm, Cm = (_t(a) for a in _inputs(1, 8, 2, 32, 16, 1,
                                               "float32"))
    with pytest.raises(ValueError, match="impl"):
        ops.ssm_scan(x, dt, A, Bm, Cm, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        K.ssm_scan_cuda(x.transpose(1, 2), dt.transpose(1, 2), A,
                        Bm.transpose(1, 2), Cm.transpose(1, 2))
    before = K.launches.count
    ops.ssm_scan(x, dt, A, Bm, Cm)                 # CPU: the plain version
    assert K.launches.count == before


def test_every_ssm_config_has_a_kernel_variant():
    """The CUDA kernel is compiled for fixed (P, N): zamba2-1.2b's at
    full width and reduced."""
    from repro_torch.configs import get_config
    for cfg in (get_config("zamba2-1.2b"),
                get_config("zamba2-1.2b").reduced()):
        assert (cfg.ssm.head_dim, cfg.ssm.d_state) in K.SIZES, cfg.name


# One SM: 228 KB of shared memory, of which each resident block reserves
# 1 KB; one block may use at most 227 KB (H100)
SM_SMEM, BLOCK_RESERVED, BLOCK_SMEM_MAX = 233_472, 1024, 232_448


@pytest.mark.parametrize("dtype,variant", [(torch.float32, "simt"),
                                           (torch.bfloat16, "mma")])
def test_the_variant_follows_the_dtype(dtype, variant):
    """fp32 x, B and C launch the SIMT kernel, bf16 the tensor-core one;
    the launch counter counts each, and a CPU call counts neither."""
    assert K.VARIANTS[dtype] == variant
    assert set(K.launches.by_variant) == {"mma", "simt"}
    x, dt, A, Bm, Cm = _inputs(1, 70, 2, 32, 16, 1, "float32")
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    before = (K.launches.count, dict(K.launches.by_variant))
    ops.ssm_scan(_t(x, name), _t(dt), _t(A), _t(Bm, name), _t(Cm, name))
    assert (K.launches.count, dict(K.launches.by_variant)) == before


def test_the_launch_counter_counts_the_scan_variants():
    from repro_torch.kernels import _build
    c = _build.LaunchCounter(variants=("mma", "simt"))
    view = c.by_variant
    for v in ("mma", "mma", "simt"):
        c.add(v)
    assert (c.count, view) == (3, {"mma": 2, "simt": 1})
    c.reset()
    assert (c.count, view) == (0, {"mma": 0, "simt": 0})


@pytest.mark.parametrize("P,N", K.SIZES)
def test_each_variant_fits_the_sm(P, N):
    """Shared memory and grid of both variants at every compiled (P, N):
    within a block's 227 KB; the mma variant four blocks an SM, two
    blocks of 128 threads a (batch, head)."""
    simt, mma = K.smem_bytes("simt", P, N), K.smem_bytes("mma", P, N)
    assert 0 < simt <= BLOCK_SMEM_MAX and 0 < mma <= BLOCK_SMEM_MAX
    assert 4 * (mma + BLOCK_RESERVED) <= SM_SMEM
    B, H = 4, 64                                     # zamba2's prefill
    assert K.launch_shape("simt", B, H) == ((H, B), 256)
    assert K.launch_shape("mma", B, H) == ((2 * H, B), 128)


def test_smem_bytes_at_the_zamba2_heads():
    """The layouts as the source's header states them (P = N = 64)."""
    assert K.smem_bytes("simt", 64, 64) == 84_224
    # two stages of x (64 x 32), B and C (64 x 64) bf16 and dt, the
    # state's two bf16 terms (32 x 64), four warps' seg
    assert K.smem_bytes("mma", 64, 64) == \
        2 * (64 * 32 * 2 + 2 * 64 * 64 * 2 + 256) + 2 * 32 * 64 * 2 + 1024


# ---- the backward's variants ------------------------------------------------

@pytest.mark.parametrize("P,N", K.SIZES)
def test_each_backward_variant_fits_the_sm(P, N):
    """Shared memory of both backward kernels at every compiled (P, N):
    within a block's 227 KB; the tensor-core one (``mma_bf16``) two
    blocks an SM."""
    simt = K.bwd_smem_bytes(P, N)
    mma = K.bwd_smem_bytes(P, N, "mma_bf16")
    assert simt == K.bwd_smem_bytes(P, N, "simt_bf16")
    assert 0 < simt <= BLOCK_SMEM_MAX and 0 < mma <= BLOCK_SMEM_MAX
    assert 2 * (mma + BLOCK_RESERVED) <= SM_SMEM
    with pytest.raises(ValueError, match="variant"):
        K.bwd_smem_bytes(P, N, "mma")


def test_backward_smem_bytes_at_the_zamba2_heads():
    """The layouts as the sources size them (P = N = 64):
    ``ssm_scan_bwd.cu``'s ``bwd_smem_floats`` (x, dy, B, C, Gc and the
    state rows padded by one float; M, Q and Z of 64 x 65; nine rows of
    64 and eight partials) and ``ssm_scan_bwd_mma.cu``'s ``Tile`` (x and
    dY's two terms, B and C, Gc's and h_s's two terms, Q^T o dt's two, in
    bf16; dt, 4 seg and 4 column-sum rows, rect, q, beta, gamma, 4
    partials, 4 scratch tiles of 16 x 17 and Gc in fp32)."""
    assert K.bwd_smem_bytes(64, 64) == 4 * (
        2 * 64 * 65 + 2 * 64 * 65 + 2 * 64 * 65 + 3 * 64 * 65 + 9 * 64 + 8)
    assert K.bwd_smem_bytes(64, 64) == 152_096
    assert K.bwd_smem_bytes(64, 64, "mma_bf16") == 114_192 == (
        2 * (3 * 64 * 64 + 2 * 64 * 64 + 4 * 64 * 64 + 2 * 64 * 64)
        + 4 * (64 + 3 * 4 * 64 + 4 + 4 * 16 * 17 + 64 * 64))


def test_backward_variant_rule():
    """fp32 takes only ``simt``; bf16 takes ``mma_bf16`` unless
    ``simt_bf16`` is named; anything else raises."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert K.BWD_VARIANTS == {f32: "simt", bf16: "mma_bf16"}
    assert K.bwd_variant(f32) == "simt" and K.bwd_variant(bf16) == "mma_bf16"
    assert K.bwd_variant(bf16, "simt_bf16") == "simt_bf16"
    for dtype, bad in ((f32, "mma_bf16"), (f32, "simt_bf16"),
                       (bf16, "simt"), (bf16, "mma")):
        with pytest.raises(ValueError, match="variant"):
            K.bwd_variant(dtype, bad)
    with pytest.raises(TypeError):
        K.bwd_variant(torch.float16)
    assert set(K.bwd_launches.by_variant) == {"simt", "mma_bf16",
                                              "simt_bf16"}


@pytest.mark.parametrize("B,H,G,hpb", [
    (32, 64, 1, 8),      # zamba2-1.2b's training step: 256 blocks
    (4, 64, 1, 1),       # its full layer: 256 blocks of one head
    (16, 64, 2, 4),      # 256 blocks of four heads
    (64, 64, 1, 8),      # at most MMA_MAX_HEADS
    (64, 12, 4, 1),      # 3 heads a group: no power of two above 1
    (8, 64, 1, 2),
    (2, 4, 2, 1),
])
def test_heads_per_block(B, H, G, hpb):
    """A block walks the largest power of two of one group's heads, up
    to MMA_MAX_HEADS, that leaves MMA_MIN_BLOCKS blocks."""
    got = K.heads_per_block(B, H, G)
    assert got == hpb
    assert (H // G) % got == 0 and got <= K.MMA_MAX_HEADS
    assert got == 1 or B * H // got >= K.MMA_MIN_BLOCKS


def test_block_partials_sum_to_the_group_sum():
    """``sum_partials`` on one fp32 partial a block of heads (the mma
    kernel's (B, H / hpb, S, N), each block's heads added in order) equals
    the group sum of the per-head gradients, in fp32, then one rounding;
    the block partials of a group are consecutive."""
    B, S, H, G, N, hpb = 2, 5, 8, 2, 4, 2
    rng = np.random.RandomState(0)
    heads = torch.tensor(rng.randn(B, S, H, N), dtype=torch.float32)
    blocks = heads.reshape(B, S, H // hpb, hpb, N)
    part = blocks[..., 0, :] + blocks[..., 1, :]          # in head order
    got = K.sum_partials(part.transpose(1, 2), G, torch.bfloat16)
    want = heads.transpose(1, 2).reshape(B, G, H // G, S, N).sum(2)
    assert got.shape == (B, G, S, N) and got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) <= \
        2.0 ** -8 * float(want.abs().max())


def test_rows_error_names_what_16_byte_rows_need():
    """The mma kernels read rows 16 bytes at a time: bf16 x, B and C
    (cp.async) and the backward's fp32 dy (float4) need every stride but
    the last a multiple of 16 bytes and a 16-byte-aligned base."""
    for dtype, per in ((torch.bfloat16, 8), (torch.float32, 4)):
        t = torch.zeros((2, 16, 3, 64), dtype=dtype)
        assert K.rows_error(t) is None
        assert K.rows_error(t.transpose(1, 2)) is None    # model layout
        wide = torch.zeros((2, 3, 16, 64 + per // 2), dtype=dtype)
        assert "multiples of" in K.rows_error(wide[..., :64])
        flat = torch.zeros(2 * 3 * 16 * 64 + per, dtype=dtype)
        assert K.rows_error(flat[per:].view(2, 3, 16, 64)) is None
        assert "aligned" in K.rows_error(
            flat[per // 2:per // 2 + 2 * 3 * 16 * 64].view(2, 3, 16, 64))
        assert K.rows_error(t.transpose(-1, -2)) is not None
