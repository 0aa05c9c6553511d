"""The port's all-fleet local trainer against the JAX reference's
``make_trainer`` (legacy host-draw variant), on the CPU.

Both trainers start from one template (carried over with
``params_from_jax``) and one set of cached client models, and get the same
random resume masks, workloads, interruption points and cache intervals.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.data.synthetic import federated_classification as ref_data
from repro.fl import classifier as RefCLF
from repro.fl.engine import make_trainer as ref_make_trainer
from repro.fl.simulator import SimConfig as RefSimConfig

from repro_torch.convert import params_from_jax
from repro_torch.core import caching as C
from repro_torch.data.synthetic import federated_classification
from repro_torch.fl.engine import BIG, make_trainer
from repro_torch.fl.simulator import SimConfig

N = 10
SIM = dict(num_clients=N, local_steps=5, batch_size=8, lr=0.1,
           model_hidden=16)
DATA = dict(dim=6, num_classes=4, n_per_client=20, n_test=16, seed=3)


def _tree_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_all_matches_reference(seed):
    rng = np.random.RandomState(seed)
    rdata = ref_data(N, **DATA)
    template = _tree_np(RefCLF.init_classifier(
        jax.random.key(seed), dim=6, num_classes=4, hidden=16, depth=2))
    cached = jax.tree.map(
        lambda a: (rng.randn(N, *a.shape) * 0.3).astype(np.float32),
        template)
    progress = rng.rand(N).astype(np.float32)
    stamp = rng.randint(-1, 3, N).astype(np.int32)
    resume = rng.rand(N) < 0.5
    steps = rng.randint(0, SIM["local_steps"] + 3, N).astype(np.int32)
    stop = np.where(rng.rand(N) < 0.4, rng.randint(0, 6, N),
                    BIG).astype(np.int32)
    every = np.where(rng.rand(N) < 0.8, rng.randint(1, 5, N),
                     BIG).astype(np.int32)

    ref_caches = ref_core.ClientCaches(
        jax.tree.map(jnp.asarray, cached), jnp.asarray(progress),
        jnp.asarray(stamp))
    want = ref_make_trainer(RefSimConfig(**SIM), rdata)(
        jax.tree.map(jnp.asarray, template), ref_caches,
        jnp.asarray(resume), jnp.asarray(steps), jnp.asarray(stop),
        jnp.asarray(every))

    caches = C.ClientCaches(params_from_jax(cached), torch.tensor(progress),
                            torch.tensor(stamp))
    got = make_trainer(SimConfig(**SIM), federated_classification(N, **DATA),
                       device="cpu")(
        params_from_jax(template), caches, torch.tensor(resume),
        torch.tensor(steps), torch.tensor(stop), torch.tensor(every))

    final, cache_p, cached_steps, loss = got
    w_final, w_cache, w_steps, w_loss = _tree_np(want)
    # fp32 SGD steps with another summation order than XLA's
    for ours, theirs in ((final, w_final), (cache_p, w_cache)):
        for layer in theirs:
            for name in theirs[layer]:
                np.testing.assert_allclose(ours[layer][name].numpy(),
                                           theirs[layer][name], atol=1e-5)
    np.testing.assert_array_equal(cached_steps.numpy(), w_steps)
    np.testing.assert_allclose(loss.numpy(), w_loss, rtol=1e-5)
    # idle clients (no steps) come back untouched
    idle = steps == 0
    for layer in template:
        for name in template[layer]:
            start = np.where(resume[:, None].reshape(
                (-1,) + (1,) * template[layer][name].ndim),
                cached[layer][name], template[layer][name][None])
            np.testing.assert_array_equal(
                final[layer][name].numpy()[idle], start[idle])


def test_trainer_leaves_no_garbage_cycles():
    """Every tensor the trainer drops is freed at once: a reference cycle
    would hold the per-step gradients until the next garbage collection
    (gigabytes on the card at N = 4096)."""
    template = _tree_np(RefCLF.init_classifier(
        jax.random.key(0), dim=6, num_classes=4, hidden=16, depth=2))
    train = make_trainer(SimConfig(**SIM),
                         federated_classification(N, **DATA), device="cpu")
    caches = C.init_caches(params_from_jax(template), N)
    args = (params_from_jax(template), caches, torch.zeros(N, dtype=bool),
            torch.full((N,), 3, dtype=torch.int32),
            torch.full((N,), BIG, dtype=torch.int32),
            torch.full((N,), 2, dtype=torch.int32))
    train(*args)                       # warm up lazy module state
    gc.collect()
    gc.disable()
    try:
        out = train(*args)
        del out
        assert gc.collect() == 0
    finally:
        gc.enable()
