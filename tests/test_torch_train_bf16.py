"""Cross-silo training of zamba2 in its own bf16 against the JAX reference,
on the CPU.

``repro.launch.train --arch zamba2-1.2b`` without ``--scale`` trains the
hybrid in bf16 (``param_dtype`` and ``compute_dtype`` "bfloat16", fp32
Adam moments); on the card the port runs it through the bf16 backward
kernels of flash attention and the SSD scan (``chip_smoke.py``'s
``[train zamba2-1.2b bf16]``).  Here both packages run a narrow bf16
zamba2 (``zamba2-1.2b.reduced()`` in bf16: 4 Mamba2 layers, the shared
attention every 2, d_model 256, vocab 512):

* the gradient of the cross-silo weighted loss, per leaf, against
  ``jax.grad`` through the reference's ``make_train_step`` in bf16;
* ``launch.train.main`` over 2 rounds of 4 silos x 4 x 32 against
  ``repro.launch.train.main``, each package's config lookup patched to
  that config: selected, received and ε identical, the loss within
  ``LOSS_RTOL`` relative.

bf16 rounds at other places in the two frameworks (XLA fuses and keeps
fp32 inside its fusions; the port rounds each op's result), so the
floats are held to tolerances measured on the CPU and written beside
them.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.launch.train as ref_train
from repro.configs import get_config as ref_get_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.fl import cross_silo as RCS
from repro.models import build_model as ref_build_model
from repro.optim import optimizers as RO

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.fl import cross_silo as CS
from repro_torch.launch import train as T
from repro_torch.models import build_model
from repro_torch.optim import optimizers as PO
from repro_torch.tree import tree_leaves

N_SILOS, PER_SILO, SEQ = 4, 2, 32
ARCH = "zamba2-1.2b"
# Measured on a CPU (torch 2.13, jax 0.9): the
# gradients differ by up to 1.15e-2 of max(1, max |g|) (the embedding) and
# 10.3% of a leaf's own max |g|; each package's bf16 gradient is 1.5-4% of
# its own max from an fp32 evaluation of the same step, the port's and
# the reference's alike (their distances' ratio has median 0.91, largest
# 2.4): rounding, not algebra (the fp32 step agrees to 1e-5,
# test_torch_train_recurrent.py).  A lost gradient is off by its whole max.
# The loss: 2.5e-4 relative in the step, 4.7e-4 in the training run's
# round 0.
GRAD_TOL = 2.5e-2      # of max(1, max |g|)
OWN_TOL = 0.3          # of the leaf's own max |g|
LOSS_RTOL = 2e-3


def _bf16(cfg):
    return cfg.reduced(param_dtype="bfloat16", compute_dtype="bfloat16")


class _GradOut:
    """An optimizer whose step returns the gradient as the new parameters:
    the train step's gradient, read through its own code path."""

    def __init__(self, init):
        self.init = init

    def step(self, params, grads, state, **kw):
        return grads, state


def _pair(seed=0):
    """The narrow bf16 zamba2 of both packages from the reference's
    parameters, every constant leaf of its init drawn 0.2 away from its
    constant and dt_bias lowered by 3 (softplus near 0.05), as
    ``tests/test_torch_train_recurrent.py`` draws them."""
    rcfg = _bf16(ref_get_config(ARCH))
    ref = ref_build_model(rcfg)
    rng = np.random.RandomState(seed)

    def draw(v):
        v = np.asarray(v)
        if np.all(v == v.flat[0]):
            v = (v.astype(np.float32)
                 + rng.randn(*v.shape).astype(np.float32) * 0.2).astype(
                v.dtype)
        return np.array(v)
    rparams = jax.tree.map(draw, jax.device_get(ref.init(
        jax.random.key(seed))))
    rparams["mamba"]["dt_bias"] = (rparams["mamba"]["dt_bias"].astype(
        np.float32) - 3.0).astype(rparams["mamba"]["dt_bias"].dtype)
    model = build_model(_bf16(get_config(ARCH)))
    return ref, rparams, model, lm_params_from_jax(rparams, rcfg.num_layers)


def test_bf16_weighted_loss_gradient_matches_jax_grad(monkeypatch):
    """S 70 (ragged against the reduced SSD's chunk of 32), silo 1 at
    weight 0: the loss within LOSS_RTOL, every leaf's gradient bf16,
    within GRAD_TOL of max(1, max |g|) and OWN_TOL of its own max |g| of
    jax.grad's, and every leaf moves."""
    ref, rparams, model, params = _pair()
    seq = 70
    tok = np.random.RandomState(1).randint(
        0, model.cfg.vocab_size, (N_SILOS * PER_SILO, seq + 1)).astype(
        np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    batch["labels"][0, :5] = -1
    w = np.array([1.0, 0.0, 0.5, 1.0], np.float32)
    monkeypatch.setattr(RCS, "make_optimizer",
                        lambda cfg: _GradOut(lambda p: RO.OptState(
                            None, None, jnp.zeros((), jnp.int32))))
    rstep = jax.jit(RCS.make_train_step(ref, RefTrainConfig(), N_SILOS))
    rstate = RCS.TrainState(jax.tree.map(jnp.asarray, rparams),
                            RO.OptState(None, None, jnp.zeros((), jnp.int32)),
                            jnp.zeros((), jnp.int32))
    rnew, rmetrics = rstep(rstate, jax.tree.map(jnp.asarray, batch),
                           jnp.asarray(w))
    want = lm_params_from_jax(jax.device_get(rnew.params),
                              model.cfg.num_layers)

    monkeypatch.setattr(CS, "make_optimizer",
                        lambda cfg: _GradOut(lambda p: PO.OptState(
                            None, None, torch.zeros((), dtype=torch.int32))))
    step = CS.make_train_step(model, TrainConfig(), N_SILOS)
    state = CS.TrainState(params, PO.OptState(
        None, None, torch.zeros((), dtype=torch.int32)),
        torch.zeros((), dtype=torch.int32))
    new, metrics = step(state, {k: torch.from_numpy(v).long()
                                for k, v in batch.items()},
                        torch.from_numpy(w))
    assert float(metrics["loss"]) == pytest.approx(float(rmetrics["loss"]),
                                                   rel=LOSS_RTOL)
    got, ref_leaves = tree_leaves(new.params), tree_leaves(want)
    assert len(got) == len(ref_leaves)
    for g, r in zip(got, ref_leaves):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
        err, scale = float((g.float() - r.float()).abs().max()), float(
            r.float().abs().max())
        assert err <= GRAD_TOL * max(1.0, scale)
        assert err <= OWN_TOL * scale
        assert bool(g.abs().max() > 0)


def test_bf16_driver_matches_reference(monkeypatch):
    """``repro_torch.launch.train.main`` against ``repro.launch.train.main``
    without ``--scale`` over 2 rounds of 4 silos x 4 x 32, both looking
    the arch up as the narrow bf16 zamba2, from the reference's
    parameters and its explore uniforms."""
    rounds = 2
    argv = ["--arch", ARCH, "--rounds", str(rounds), "--silos", "4",
            "--seq-len", str(SEQ), "--log-every", "1", "--seed", "0"]
    rcfg = _bf16(ref_get_config(ARCH))
    want = {"loss": [], "selected": [], "received": [], "epsilon": []}

    class JaxRecording:
        """``jax`` as ``repro.launch.train`` sees it, with a ``jit`` that
        records each step's loss."""

        def __getattr__(self, name):
            return getattr(jax, name)

        def jit(self, fn, **kw):
            jitted = jax.jit(fn, **kw)

            def run(*args):
                out = jitted(*args)
                want["loss"].append(float(out[1]["loss"]))
                return out
            return run

    plan_round, update = ref_core.plan_round, ref_core.update_after_round

    def plan(*args, **kw):
        p = plan_round(*args, **kw)
        want["selected"].append(int(np.asarray(p.selected).sum()))
        return p

    def after(state, plan, received, cfg):
        s = update(state, plan, received, cfg)
        want["received"].append(int(np.asarray(received).sum()))
        want["epsilon"].append(float(s.epsilon))
        return s

    monkeypatch.setattr(ref_core, "plan_round", plan)
    monkeypatch.setattr(ref_core, "update_after_round", after)
    monkeypatch.setattr(ref_train, "jax", JaxRecording())
    monkeypatch.setattr(ref_train, "get_config", lambda name: rcfg)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    ref_train.main()

    cfg = _bf16(get_config(ARCH))
    monkeypatch.setattr(T, "scaled_config", lambda name, scale=None: cfg)
    rparams = ref_build_model(rcfg).init(jax.random.key(0))
    params = lm_params_from_jax(jax.device_get(rparams), rcfg.num_layers)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(params))
    uniforms, rng = [], jax.random.key(1)        # key(seed + 1)
    for _ in range(rounds):
        rng, k1 = jax.random.split(rng)
        uniforms.append(torch.from_numpy(np.array(
            jax.random.uniform(k1, (4,)))))
    state, log = T.main(argv + ["--device", "cpu"], params=params,
                        explore_uniforms=lambda rnd: uniforms[rnd])
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(state.params))
    assert [r["selected"] for r in log] == want["selected"]
    assert [r["received"] for r in log] == want["received"]
    assert [r["epsilon"] for r in log] == want["epsilon"]
    np.testing.assert_allclose([r["loss"] for r in log], want["loss"],
                               rtol=LOSS_RTOL)
    # the moments stay fp32 (TrainConfig.moment_dtype) under bf16 weights
    assert all(t.dtype == torch.float32 for t in tree_leaves(
        state.opt_state.mu) + tree_leaves(state.opt_state.nu))
    assert int(state.step) == rounds
    assert sum(want["received"]) > 0
