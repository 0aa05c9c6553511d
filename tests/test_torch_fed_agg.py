"""The port's ``fed_agg`` wrappers against the JAX reference, on the CPU.

``impl="torch"`` (the plain version) and ``impl="cuda"`` on CPU tensors
(which takes the plain version: a CPU has no kernel to run) are held to
JAX's ``fed_agg_packed`` under ``"xla"`` and ``"pallas_interpret"`` on the
same numpy inputs.  The kernel itself is held to the plain version on the
card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as RefAGG
from repro.kernels.fed_agg.ops import fed_agg_packed as ref_fed_agg_packed

from repro_torch.core import aggregation as AGG
from repro_torch.kernels.fed_agg import kernel as K
from repro_torch.kernels.fed_agg.ops import fed_agg, fed_agg_packed

# fp32 on both sides, different summation order
ATOL = 1e-6


def _inputs(C, D, seed, zero_frac=0.0):
    rng = np.random.RandomState(seed)
    u = rng.randn(C, D).astype(np.float32)
    w = rng.rand(C).astype(np.float32)
    w[rng.rand(C) < zero_frac] = 0.0
    return u, w / max(w.sum(), 1e-30)


@pytest.mark.parametrize("C,D,zero_frac", [(13, 2049, 0.0), (1, 7, 0.0),
                                           (40, 300, 0.6), (8, 2048, 1.0)])
@pytest.mark.parametrize("ref_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_fed_agg_packed_matches_reference(C, D, zero_frac, ref_impl, impl):
    u, w = _inputs(C, D, seed=C * D, zero_frac=zero_frac)
    want = np.asarray(ref_fed_agg_packed(jnp.asarray(u), jnp.asarray(w),
                                         impl=ref_impl))
    launches = K.launches.count
    got = fed_agg_packed(torch.from_numpy(u), torch.from_numpy(w),
                         impl=impl)
    assert K.launches.count == launches       # no kernel on the CPU
    assert got.shape == (D,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_fed_agg_stacked_keeps_shape_and_dtype():
    u, w = _inputs(5, 24, seed=1)
    got = fed_agg(torch.from_numpy(u).reshape(5, 2, 3, 4),
                  torch.from_numpy(w), impl="torch")
    assert got.shape == (2, 3, 4)
    np.testing.assert_allclose(got.reshape(-1).numpy(), w @ u, atol=ATOL)


def test_fed_agg_rejects_unknown_impl():
    u, w = _inputs(2, 3, seed=2)
    with pytest.raises(ValueError, match="impl"):
        fed_agg_packed(torch.from_numpy(u), torch.from_numpy(w), impl="xla")


def _model(rng, lead=()):
    shapes = {"a": {"w": (3, 5), "b": (5,)}, "z": {"w": (5, 2), "b": (2,)}}
    return {k: {n: rng.randn(*lead, *s).astype(np.float32)
                for n, s in v.items()} for k, v in shapes.items()}


def _to_torch(tree):
    return {k: {n: torch.from_numpy(a) for n, a in v.items()}
            for k, v in tree.items()}


@pytest.mark.parametrize("weights", [[0.5, 0.0, 2.0, 1.0, 0.25],
                                     [0.0] * 5])
def test_fed_aggregate_packed_matches_reference(weights):
    """Whole-model packed aggregation, including the Σw == 0 passthrough
    of the previous global model."""
    rng = np.random.RandomState(3)
    g, c = _model(rng), _model(rng, lead=(5,))
    w = np.asarray(weights, np.float32)
    want = RefAGG.fed_aggregate_packed(
        {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in g.items()},
        {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in c.items()},
        jnp.asarray(w), impl="pallas_interpret", block_c=4, block_d=16)
    got = AGG.fed_aggregate_packed(_to_torch(g), _to_torch(c),
                                   torch.from_numpy(w), impl="cuda")
    for k in g:
        for n in g[k]:
            np.testing.assert_allclose(got[k][n].numpy(),
                                       np.asarray(want[k][n]), atol=ATOL)
    if not any(weights):
        for k in g:
            for n in g[k]:
                np.testing.assert_array_equal(got[k][n].numpy(), g[k][n])


def test_pack_layout_follows_reference_tree_order():
    rng = np.random.RandomState(4)
    g, c = _model(rng), _model(rng, lead=(3,))
    ref = RefAGG.pack_layout(g)
    layout = AGG.pack_layout(_to_torch(g))
    assert (layout.shapes, layout.sizes, layout.offsets, layout.dim) == \
        (ref.shapes, ref.sizes, ref.offsets, ref.dim)
    np.testing.assert_array_equal(
        AGG.pack_stacked(_to_torch(c), layout).numpy(),
        np.asarray(RefAGG.pack_stacked(c, ref)))
    vec = AGG.pack(_to_torch(g), layout)
    back = AGG.unpack(vec, layout)
    for k in g:
        for n in g[k]:
            np.testing.assert_array_equal(back[k][n].numpy(), g[k][n])
    with pytest.raises(ValueError, match="layout"):
        AGG.pack({"a": _to_torch(g)["a"]}, layout)


@pytest.mark.parametrize("C,D", [(4096, 22026), (13, 22026), (4096, 1),
                                 (1, 5), (0, 9), (100000, 3),
                                 (4096, 22027), (517, 2_000_001)])
@pytest.mark.parametrize("block_c,block_d", [(8, 2048), (1, 256), (5, 512)])
def test_kernel_grid_covers_every_row_and_column(C, D, block_c, block_d):
    g = K.geometry(C, D, block_c, block_d)
    assert 1 <= g.n_chunks <= 65535                  # CUDA grid.y limit
    assert g.col_blocks * g.n_chunks <= max(K.WAVE, g.col_blocks)
    # the chunks tile [0, C) in order, each starting on a block of rows,
    # and differ in size by at most one block
    bounds = [K.chunk_rows(g, C, block_c, i) for i in range(g.n_chunks)]
    assert bounds[0][0] == 0 and bounds[-1][1] == C
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(lo % block_c == 0 and lo <= hi for lo, hi in bounds)
    sizes = [hi - lo for lo, hi in bounds[:-1]] or [0]
    assert max(sizes) - min(sizes) <= block_c
    assert g.cols_per_thread * K.THREADS == block_d
    assert (g.col_blocks - 1) * block_d < D <= g.col_blocks * block_d


def test_kernel_grid_at_the_main_path_shape_fills_the_card():
    g = K.geometry(4096, 22026)
    # one whole wave: 11 column blocks x 12 chunks, a block on each of
    # the 132 SMs
    assert g.col_blocks * g.n_chunks == K.WAVE == 132
    assert g.vec == 2                                # float2 loads
    # the partials add at most a few percent to the bytes read
    assert g.n_chunks * 22026 * 4 * 2 < 0.05 * 4096 * 22026 * 4


@pytest.mark.parametrize("D,block_d,aligned,vec", [
    (22026, 2048, True, 2), (22027, 2048, True, 1), (22026, 2048, False, 1),
    (22026, 256, True, 1), (22025, 512, True, 1), (22024, 512, True, 2),
    (1, 2048, True, 1), (2, 1024, True, 2)])
def test_kernel_grid_takes_float2_loads_only_where_rows_align(
        D, block_d, aligned, vec):
    """float2 loads need every row start 8-byte aligned: an even D and an
    aligned buffer; odd D (rows alternate) and 256-wide blocks (one column
    a thread) take scalar loads."""
    assert K.geometry(64, D, 8, block_d, aligned=aligned).vec == vec


@pytest.mark.parametrize("block_c,block_d", [(0, 2048), (8, 100),
                                             (8, 4096)])
def test_kernel_grid_rejects_tiles_it_has_no_variant_for(block_c, block_d):
    with pytest.raises(ValueError):
        K.geometry(64, 64, block_c, block_d)
