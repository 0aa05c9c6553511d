"""The port's FLUDE planning (Alg. 1 selection, Eq. 4 distribution, Alg. 2
quorum and budget loop) and post-round bookkeeping against the JAX
reference, round after round on random online masks, caches and receipts.

The reference draws its explore noise inside the selector from the round
key; the test draws the same ``jax.random.uniform(k, (N,))`` and hands it
to the port.  Integer outputs must be equal; float state within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.configs.base import FLConfig as RefFLConfig

from repro_torch.configs.base import FLConfig
from repro_torch.core import caching as C
from repro_torch.core import round as R

N = 30
# float32 scalar state computed op for op like the reference
ATOL = 1e-6


def _eq(ours, theirs):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def _close(ours, theirs):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL,
                               rtol=0)


def _check_state(ours: R.FludeState, theirs):
    _eq(ours.belief.alpha, theirs.belief.alpha)
    _eq(ours.belief.beta, theirs.belief.beta)
    for name in ("part_count", "explored", "in_v", "total_selected",
                 "round"):
        _eq(getattr(ours, name), getattr(theirs, name))
    _close(ours.epsilon, theirs.epsilon)
    for a, b in zip(ours.distributor, theirs.distributor):
        _close(a, b)


@pytest.mark.parametrize("hints,mode,budget", [
    (False, "adaptive", float("inf")),    # uniforms decide exploration
    (True, "adaptive", float("inf")),     # the engine's hinted path
    (True, "full", float("inf")),
    (False, "least", float("inf")),
    (True, "adaptive", 9.0),              # Alg. 2 budget loop shrinks X
])
def test_plan_and_update_match_reference(hints, mode, budget):
    """Five rounds from fresh Beta(2, 2) beliefs: the first rounds rank
    among many equal beliefs, so tie order (stable argsort) matters."""
    rng = np.random.RandomState(7)
    kw = dict(num_clients=N, clients_per_round=10, distribution_mode=mode,
              comm_budget=budget)
    ref_cfg, cfg = RefFLConfig(**kw), FLConfig(**kw)
    ref_state, state = ref_core.init_state(ref_cfg), R.init_state(cfg)
    hint = rng.rand(N).astype(np.float32)
    hint[::3] = hint[0]                   # equal hints: the noise breaks ties
    key = jax.random.key(11)
    for rnd in range(5):
        key, k = jax.random.split(key)
        online = rng.rand(N) < 0.7
        stamp = np.where(rng.rand(N) < 0.5, rng.randint(0, rnd + 1, N),
                         -1).astype(np.int32)
        progress = rng.rand(N).astype(np.float32)
        ref_caches = ref_core.ClientCaches({}, jnp.asarray(progress),
                                           jnp.asarray(stamp))
        caches = C.ClientCaches({}, torch.tensor(progress),
                                torch.tensor(stamp))
        want = ref_core.plan_round(
            ref_state, ref_caches, jnp.asarray(online), ref_cfg, k,
            explore_hints=jnp.asarray(hint) if hints else None)
        got = R.plan_round(
            state, caches, torch.tensor(online), cfg,
            torch.tensor(np.asarray(jax.random.uniform(k, (N,)))),
            explore_hints=torch.tensor(hint) if hints else None)
        for name in ("selected", "distribute", "resume"):
            _eq(getattr(got, name), getattr(want, name))
        for name in ("quorum", "predicted_cost", "avg_dependability",
                     "priority"):
            _close(getattr(got, name), getattr(want, name))
        for a, b in zip(got.distributor, want.distributor):
            _close(a, b)
        assert int(got.selected.sum()) > 0

        received = np.asarray(want.selected) & (rng.rand(N) < 0.6)
        ref_state = ref_core.update_after_round(
            ref_state, want, jnp.asarray(received), ref_cfg)
        state = R.update_after_round(state, got, torch.tensor(received),
                                     cfg)
        _check_state(state, ref_state)


def test_init_state_matches_reference():
    cfg = dataclasses.replace(FLConfig(num_clients=N), w_init=4.5)
    ref_cfg = dataclasses.replace(RefFLConfig(num_clients=N), w_init=4.5)
    _check_state(R.init_state(cfg), ref_core.init_state(ref_cfg))


def test_staleness_and_cache_interval_match_reference():
    rng = np.random.RandomState(1)
    stamp = rng.randint(-1, 6, N).astype(np.int32)
    caches = C.ClientCaches({}, torch.zeros(N), torch.tensor(stamp))
    ref = ref_core.ClientCaches({}, jnp.zeros(N), jnp.asarray(stamp))
    _eq(C.staleness(caches, 7), ref_core.staleness(ref, 7))
    _eq(C.has_cache(caches), ref_core.has_cache(ref))
    battery, stability = rng.rand(N), rng.rand(N)
    _eq(C.adaptive_cache_interval(2.0, battery, stability),
        ref_core.adaptive_cache_interval(2.0, battery, stability))
