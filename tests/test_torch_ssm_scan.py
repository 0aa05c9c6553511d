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
  tensors, the variant rule, each variant's shared memory and grid, the
  op's copy of rows the tensor-core kernels cannot read;
* the fp32 tensor-core forward's rounding points
  (``ref.ssm_scan_fwd_f32_mirror``) against a float64 truth, beside
  ``ssd_fwd_simt``'s algebra (``ref.ssm_scan_chunked_ref``) in fp32.

The CUDA kernel itself is held to ``ssm_scan_ref`` on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import contextlib
import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_scan_ref

from repro_torch.kernels.ssm_scan import kernel as K
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan import ref as R
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


@pytest.mark.parametrize("dtype,variant", [(torch.float32, "mma_f32"),
                                           (torch.bfloat16, "mma")])
def test_the_variant_follows_the_dtype(dtype, variant):
    """fp32 x, B and C launch the fp32 tensor-core kernel, bf16 the bf16
    one; the launch counter counts each and the SIMT kernel, and a CPU
    call counts none."""
    assert K.VARIANTS[dtype] == variant == K.fwd_variant(dtype)
    assert set(K.launches.by_variant) == {"mma_f32", "mma", "simt"}
    x, dt, A, Bm, Cm = _inputs(1, 70, 2, 32, 16, 1, "float32")
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    before = (K.launches.count, dict(K.launches.by_variant))
    ops.ssm_scan(_t(x, name), _t(dt), _t(A), _t(Bm, name), _t(Cm, name))
    assert (K.launches.count, dict(K.launches.by_variant)) == before


def test_forward_variant_rule():
    """fp32 takes ``mma_f32`` unless ``simt`` is named; bf16 takes
    ``mma`` only; anything else raises, as the backward's rule does."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert K.fwd_variant(f32, "simt") == "simt"
    assert K.fwd_variant(f32, "mma_f32") == "mma_f32"
    assert K.fwd_variant(bf16, "mma") == "mma"
    for dtype, bad in ((bf16, "mma_f32"), (bf16, "simt"), (f32, "mma"),
                       (f32, "mma_bf16"), (f32, "wgmma")):
        with pytest.raises(ValueError, match="variant"):
            K.fwd_variant(dtype, bad)
    with pytest.raises(TypeError):
        K.fwd_variant(torch.float16)
    assert set(K.FWD_CODES) == {v for vs in K.FWD_ALLOWED.values()
                                for v in vs}


def test_the_launch_counter_counts_the_scan_variants():
    from repro_torch.kernels import _build
    c = _build.LaunchCounter(variants=("mma_f32", "mma", "simt"))
    view = c.by_variant
    for v in ("mma", "mma_f32", "mma_f32", "simt"):
        c.add(v)
    assert (c.count, view) == (4, {"mma_f32": 2, "mma": 1, "simt": 1})
    c.reset()
    assert (c.count, view) == (0, {"mma_f32": 0, "mma": 0, "simt": 0})


@pytest.mark.parametrize("P,N", K.SIZES)
def test_each_variant_fits_the_sm(P, N):
    """Shared memory and grid of the three variants at every compiled (P,
    N): within a block's 227 KB; the bf16 mma variant four blocks an SM,
    the fp32 one three, each two blocks of 128 threads a (batch, head)."""
    simt, mma = K.smem_bytes("simt", P, N), K.smem_bytes("mma", P, N)
    f32 = K.smem_bytes("mma_f32", P, N)
    assert all(0 < b <= BLOCK_SMEM_MAX for b in (simt, mma, f32))
    assert 4 * (mma + BLOCK_RESERVED) <= SM_SMEM
    assert 3 * (f32 + BLOCK_RESERVED) <= SM_SMEM
    B, H = 32, 24                                    # zamba2 100m training
    assert K.launch_shape("simt", B, H) == ((H, B), 256)
    assert K.launch_shape("mma", B, H) == ((2 * H, B), 128)
    assert K.launch_shape("mma_f32", B, H) == ((2 * H, B), 128)
    with pytest.raises(ValueError, match="variant"):
        K.smem_bytes("mma_bf16", P, N)


def test_smem_bytes_at_the_zamba2_heads():
    """The layouts as the source's header states them (P = N = 64)."""
    assert K.smem_bytes("simt", 64, 64) == 84_224
    # two stages of x (64 x 32), B and C (64 x 64) bf16 and dt, the
    # state's two bf16 terms (32 x 64), four warps' seg
    assert K.smem_bytes("mma", 64, 64) == \
        2 * (64 * 32 * 2 + 2 * 64 * 64 * 2 + 256) + 2 * 32 * 64 * 2 + 1024
    # three bf16 planes of x (64 x 32), B, C (64 x 64) and the state (32
    # x 64); dt and the seg's hi and lo
    assert K.smem_bytes("mma_f32", 64, 64) == 74_496 == \
        3 * 2 * (64 * 32 + 2 * 64 * 64 + 32 * 64) + 4 * 3 * 64


def test_the_op_copies_rows_the_kernels_cannot_read():
    """``ops.readable_rows``, which the op applies to x, B and C before a
    launch: a view whose rows the tensor-core kernels read 16 bytes at a
    time passes as it is (the model's split projection), any other is
    copied to contiguous memory with the same values."""
    for dtype in (torch.float32, torch.bfloat16):
        per = 16 // torch.tensor([], dtype=dtype).element_size()
        proj = torch.randn(2, 9, 3 * 32 + 2 * 16).to(dtype)
        x = proj[..., :96].reshape(2, 9, 3, 32).transpose(1, 2)
        assert ops.readable_rows(x) is x
        odd = torch.randn(2, 9, 3 * 32 + per // 2).to(dtype)
        xo = odd[..., :96].reshape(2, 9, 3, 32).transpose(1, 2)
        got = ops.readable_rows(xo)
        assert K.rows_error(xo) is not None and K.rows_error(got) is None
        assert got is not xo and torch.equal(got, xo)


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
    """fp32 takes ``mma_f32`` unless ``simt`` is named; bf16 takes
    ``mma_bf16`` unless ``simt_bf16`` is named; anything else raises."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert K.BWD_VARIANTS == {f32: "mma_f32", bf16: "mma_bf16"}
    assert K.bwd_variant(f32) == "mma_f32"
    assert K.bwd_variant(bf16) == "mma_bf16"
    assert K.bwd_variant(f32, "simt") == "simt"
    assert K.bwd_variant(bf16, "simt_bf16") == "simt_bf16"
    for dtype, bad in ((f32, "mma_bf16"), (f32, "simt_bf16"),
                       (bf16, "simt"), (bf16, "mma"), (bf16, "mma_f32"),
                       (f32, "mma")):
        with pytest.raises(ValueError, match="variant"):
            K.bwd_variant(dtype, bad)
    with pytest.raises(TypeError):
        K.bwd_variant(torch.float16)
    assert set(K.bwd_launches.by_variant) == {"simt", "mma_bf16",
                                              "simt_bf16", "mma_f32"}


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


# ---- the fp32 tensor-core backward (mma_f32) ---------------------------------

@pytest.mark.parametrize("P,N", K.SIZES)
def test_fp32_backward_fits_a_block(P, N):
    """``ssd_bwd_mma_f32``'s shared memory at every compiled (P, N):
    within a block's 227 KB (one block an SM at P = N = 64)."""
    got = K.bwd_smem_bytes(P, N, "mma_f32")
    assert 0 < got <= BLOCK_SMEM_MAX
    assert got > K.bwd_smem_bytes(P, N, "mma_bf16")


def test_fp32_backward_smem_bytes_at_the_zamba2_heads():
    """The layout as ``TileF32`` sizes it (P = N = 64): three bf16 term
    planes of x, dY, B, C, Gc and Q^T o dt, two of h_s; dt, 8 seg hi, 8
    seg lo and 4 column-sum rows, rect, q, beta, gamma, 8 partials, 4
    scratch tiles of 16 x 17 and Gc in fp32."""
    plane = 64 * 64 * 2
    floats = 64 + 16 * 64 + 4 * 64 + 4 * 64 + 8 + 4 * 16 * 17 + 64 * 64
    assert K.bwd_smem_bytes(64, 64, "mma_f32") == 20 * plane + 4 * floats \
        == 191_008


@pytest.mark.parametrize("B,H,G,hpb", [
    (32, 24, 1, 1),      # zamba2 100m's training step: 768 blocks
    (32, 12, 1, 1),      # 10m: 384
    (4, 64, 1, 1),       # zamba2-1.2b's full layer: 256
    (2, 4, 2, 1),
    (1, 8, 1, 1),
])
def test_fp32_heads_per_block(B, H, G, hpb):
    """``mma_f32`` walks one head a block (measured on the H100: two and
    four heads a block were slower at the training shapes and the full
    layer, PERF.md): one block of 256 threads (two warpgroups) a (batch,
    head); the bf16 kernel keeps its ``heads_per_block``."""
    assert K.bwd_launch_shape("mma_f32", B, H, G) == ((H // hpb, B), 256)
    assert K.bwd_launch_shape("mma_bf16", B, H, G) == (
        (H // K.heads_per_block(B, H, G), B), 128)
    assert K.heads_per_block(32, 64, 1) == 8      # bf16 keeps its own


# ---- the fp32 tensor-core forward's rounding points --------------------------
# ssd_fwd_mma_f32 passes every factor of its chunk products to the tensor
# cores as three bf16 terms (x, B, C, the state, M' and B o w o dt), sums
# each k-step's products into a zeroed partial (the tensor cores truncate
# each mma's sum) and keeps the within-chunk cumsum of dt A as a
# compensated pair.  ref.ssm_scan_fwd_f32_mirror models those points; held
# here to float64 through the per-step oracle against
# ref.ssm_scan_chunked_ref in fp32 (ssd_fwd_simt's algebra, the
# yardstick): y and the final state of the mirror no more than
# F32_RATIO times as far from float64.

F32_RATIO = 2.0
# (B, H, S, P, N, G, h0, bf16 dt): zamba2's heads at the training S 128
# and at S 1024 (64 chunks of the full layer cut to 16), ragged S with G
# > 1 and h0, P 32 / N 16 with a bf16 dt, and S 1 and S 5 with h0, where
# the state's own terms carry y
F32_FWD_SHAPES = [
    (1, 2, 128, 64, 64, 1, False, False),
    (1, 2, 1024, 64, 64, 1, False, False),
    (1, 4, 300, 64, 64, 2, True, False),
    (2, 4, 130, 32, 16, 2, True, True),
    (2, 8, 1, 64, 64, 1, True, False),
    (2, 8, 5, 64, 16, 1, True, False),
]


def _f32_fwd_case(B, H, S, P, N, G, h0, dt_bf16):
    """fp32 x, B, C (per group), A and h0, fp32 or bf16 dt, drawn as
    ``chip_smoke.py``'s ``_ssd_inputs`` draws them."""
    rng = np.random.RandomState(S + N + H)
    f32 = torch.float32
    x = torch.tensor(rng.randn(B, H, S, P) * 0.5, dtype=f32)
    dt = torch.tensor(np.log1p(np.exp(rng.randn(B, H, S))), dtype=f32)
    if dt_bf16:
        dt = dt.to(torch.bfloat16)
    A = torch.tensor(-np.exp(rng.rand(H) * 2.8), dtype=f32)
    Bm, Cm = (torch.tensor(rng.randn(B, G, S, N) * 0.5, dtype=f32)
              for _ in range(2))
    hh = torch.tensor(rng.randn(B, H, P, N), dtype=f32) if h0 else None
    return [x, dt, A, Bm, Cm, hh]


@contextlib.contextmanager
def _one_thread():
    """The mirror's many small products on one thread (a thread pool's
    waits slow them by orders of magnitude under the parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _f32_fwd_yardstick(shape):
    """The case's float64 truth (y, state) and ssd_fwd_simt's algebra's
    distance from it (max |y - truth|, max |h - truth|)."""
    args = _f32_fwd_case(*shape)
    rep = shape[1] // shape[5]
    d = [None if a is None else a.double() for a in args]
    with _one_thread():
        truth = ssm_scan_ref(d[0], d[1], d[2],
                             d[3].repeat_interleave(rep, 1),
                             d[4].repeat_interleave(rep, 1), d[5])
        simt = R.ssm_scan_chunked_ref(*args)
    return args, truth, tuple(float((s.double() - t).abs().max())
                              for s, t in zip(simt, truth))


def _f32_fwd_ratios(shape, **mirror):
    """(y, state): the mirror's float64 distance over ssd_fwd_simt's
    algebra's, each distance max |x - truth|."""
    args, truth, simt = _f32_fwd_yardstick(shape)
    with _one_thread():
        got = R.ssm_scan_fwd_f32_mirror(*args, **mirror)
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in got)
    return tuple(float((g.double() - t).abs().max()) / max(s, 1e-300)
                 for g, t, s in zip(got, truth, simt))


@pytest.mark.parametrize("shape", F32_FWD_SHAPES)
def test_ssd_fwd_f32_mirror_in_the_kernels_terms_passes_the_gate(shape):
    y, h = _f32_fwd_ratios(shape)
    print(f"fp32 forward mirror {shape}: y {y:.3f}, state {h:.3f}")
    assert max(y, h) <= F32_RATIO, (y, h)


@pytest.mark.parametrize("factor", R.FWD_F32_FACTORS)
def test_ssd_fwd_f32_mirror_with_a_factor_in_one_term_fewer(factor):
    """Each factor one term fewer than the kernel's (``FWD_F32_TERMS``,
    the fewest that pass), reported at every shape: each then fails the
    gate at one shape at least."""
    terms = dict(R.FWD_F32_TERMS, **{factor: R.FWD_F32_TERMS[factor] - 1})
    worst = max(max(_f32_fwd_ratios(s, terms=terms))
                for s in F32_FWD_SHAPES)
    print(f"fp32 forward mirror, {factor} in {terms[factor]} terms: "
          f"worst {worst:.3f}")
    assert worst > F32_RATIO


def test_ssd_fwd_f32_mirror_with_one_partial_a_product():
    """Each chunk product summed over all of its k-steps in one zeroed
    partial (every mma's truncation at the running sum's size): reported,
    and y then lies past the gate at S 1, where the k-step partials keep
    it within."""
    shape = F32_FWD_SHAPES[4]
    steps, whole = _f32_fwd_ratios(shape), \
        _f32_fwd_ratios(shape, per_step=False)
    print(f"fp32 forward mirror {shape}: k-step partials {steps}, one "
          f"partial a product {whole}")
    assert whole[0] > F32_RATIO >= steps[0]


@pytest.mark.parametrize("shape", F32_FWD_SHAPES)
def test_ssd_fwd_f32_mirror_unrounded_is_the_reference(shape):
    """terms=None on float64 inputs: the fp32 kernel's algebra (the
    compensated cumsum in log2 units, M' with dt folded in, the k-step
    partials, the skipped C stateᵀ on chunk 0 without h0) is
    ``ssm_scan_ref``'s and ``ssm_scan_chunked_ref``'s, within 1e-10 of
    max(1, |y|)."""
    args = [None if a is None else a.double()
            for a in _f32_fwd_case(*shape[:7], False)]
    rep = shape[1] // shape[5]
    with _one_thread():
        got = R.ssm_scan_fwd_f32_mirror(*args, terms=None)
        want = ssm_scan_ref(args[0], args[1], args[2],
                            args[3].repeat_interleave(rep, 1),
                            args[4].repeat_interleave(rep, 1), args[5])
        chunked = R.ssm_scan_chunked_ref(*args)
    for g, w, c in zip(got, want, chunked):
        assert g.dtype == torch.float64
        top = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-10 * top
        assert float((c - w).abs().max()) <= 1e-10 * top


@pytest.mark.parametrize("B,S,H,P,N,G,chunk,dtype", CASES[:5])
def test_ssd_fwd_f32_mirror_matches_jax_xla_and_pallas_interpret(
        B, S, H, P, N, G, chunk, dtype):
    """The mirror in the kernel's terms, fp32, in the model's layout
    against JAX's ``ssm_scan`` under ``impl="xla"`` (the per-step oracle)
    and ``impl="pallas_interpret"`` (the Pallas kernel's chunked form), at
    the chunked form's tolerance."""
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, N, G, dtype, seed=4)
    kl = lambda a: torch.from_numpy(np.moveaxis(a, 1, 2).copy())  # noqa
    with _one_thread():
        y, h = R.ssm_scan_fwd_f32_mirror(kl(x), kl(dt), torch.tensor(A),
                                         kl(Bm), kl(Cm))
    y = y.transpose(1, 2)
    jargs = (_j(x), _j(dt), _j(A), _j(Bm), _j(Cm))
    for impl, kw in (("xla", {}), ("pallas_interpret", {"chunk": chunk})):
        jy, jh = jax_ssm_scan(*jargs, impl=impl, **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **CHUNK_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **CHUNK_TOL)
