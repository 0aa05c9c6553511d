"""The port's full-scan server round step against the JAX reference's
``make_server_round_step`` on random round masks, stamps and progress.

Both steps run three rounds from the same start, each fed its own previous
output, with failures, resumes from stale caches (staleness discount),
policy weight multipliers and an empty round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.fl import classifier as RefCLF

from repro_torch.convert import params_from_jax
from repro_torch.core import caching as C
from repro_torch.core import round as R

N, LOCAL_STEPS = 10, 4
# fp32 weighted means over the same terms in another summation order
ATOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _assert_params(ours, theirs, atol):
    for layer in theirs:
        for name in theirs[layer]:
            np.testing.assert_allclose(ours[layer][name].numpy(),
                                       np.asarray(theirs[layer][name]),
                                       atol=atol)


@pytest.mark.parametrize("uses_cache", [True, False])
@pytest.mark.parametrize("ref_impl,impl", [("xla", "torch"),
                                           ("pallas_interpret", "cuda")])
def test_server_round_step_matches_reference(ref_impl, impl, uses_cache):
    rng = np.random.RandomState(0)
    template = _np(RefCLF.init_classifier(jax.random.key(1), dim=6,
                                          num_classes=3, hidden=8, depth=2))
    stacked = jax.tree.map(
        lambda a: rng.randn(N, *a.shape).astype(np.float32), template)
    progress = (rng.randint(0, LOCAL_STEPS + 1, N) / LOCAL_STEPS
                ).astype(np.float32)
    stamp = rng.randint(-1, 2, N).astype(np.int32)

    ref_step = ref_core.make_server_round_step(
        template, local_steps=LOCAL_STEPS, agg_impl=ref_impl, block_c=4,
        block_d=16, uses_cache=uses_cache)
    step = R.make_server_round_step(params_from_jax(template),
                                    local_steps=LOCAL_STEPS, agg_impl=impl,
                                    uses_cache=uses_cache)
    g_ref = jax.tree.map(jnp.asarray, template)
    c_ref = ref_core.ClientCaches(jax.tree.map(jnp.asarray, stacked),
                                  jnp.asarray(progress), jnp.asarray(stamp))
    g = params_from_jax(template)
    c = C.ClientCaches(params_from_jax(stacked), torch.tensor(progress),
                       torch.tensor(stamp))
    n_samples = np.full(N, 32.0, np.float32)
    for rnd in range(2, 5):
        final = jax.tree.map(
            lambda a: rng.randn(N, *a.shape[1:]).astype(np.float32), stacked)
        cache_p = jax.tree.map(lambda a: a * 0.5, final)
        cached_steps = rng.randint(0, LOCAL_STEPS + 1, N).astype(np.int32)
        selected = rng.rand(N) < 0.8
        fail = selected & (rng.rand(N) < 0.4)
        received = selected & ~fail
        if rnd == 3:
            received[:] = False                    # empty round
        resume = selected & (rng.rand(N) < 0.5)
        extra_w = rng.choice([0.5, 1.0, 2.0], N).astype(np.float32)
        masks = (selected, fail, received, resume)

        g_ref, c_ref = ref_step(
            g_ref, c_ref, jax.tree.map(jnp.asarray, final),
            jax.tree.map(jnp.asarray, cache_p), jnp.asarray(cached_steps),
            *map(jnp.asarray, masks), jnp.asarray(n_samples),
            jnp.asarray(extra_w), rnd)
        g, c = step(g, c, params_from_jax(final), params_from_jax(cache_p),
                    torch.tensor(cached_steps), *map(torch.tensor, masks),
                    torch.tensor(n_samples), torch.tensor(extra_w), rnd)

        _assert_params(g, _np(g_ref), ATOL)
        _assert_params(c.params, _np(c_ref.params), ATOL)
        np.testing.assert_array_equal(c.progress.numpy(),
                                      np.asarray(c_ref.progress))
        np.testing.assert_array_equal(c.round_stamp.numpy(),
                                      np.asarray(c_ref.round_stamp))


def test_host_round_cut_matches_reference():
    rng = np.random.RandomState(5)
    for _ in range(50):
        times = np.where(rng.rand(12) < 0.6, rng.rand(12) * 900, np.inf)
        quorum = float(rng.randint(0, 13))
        for waits in (True, False):
            assert R.host_round_cut(times, quorum, 600.0, waits) == \
                ref_core.host_round_cut(times, quorum, 600.0, waits)
