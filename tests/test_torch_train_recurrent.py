"""Cross-silo training of the recurrent stacks (zamba2's Mamba2 hybrid and
RWKV6) against the JAX reference, on the CPU.

* The gradient of the cross-silo weighted loss, per leaf, for
  ``zamba2-1.2b.reduced()`` and ``rwkv6-7b.reduced()`` (every constant
  leaf of the reference's init drawn away from its constant, so that
  every path acts; ``DRAW`` says how far), against ``jax.grad`` through the reference's own
  ``make_train_step``, as ``tests/test_torch_train.py`` holds
  flude-paper: within 1e-5 of max(1, max |g|), and every leaf moves.
* The driver, ``--arch zamba2-1.2b --scale 10m --device cpu`` over 2
  rounds of 4 silos at S 32, against ``repro.launch.train.main`` from
  the reference's parameters and explore uniforms: selected, received
  and ε identical, the loss within 1e-4 relative.  The same run of
  ``rwkv6-7b`` is ``tests/test_torch_train_rwkv6.py``: the reference's
  compile takes ~20 s a stack, and each file keeps under a minute.

On a CPU tensor the port's scans are the plain forms (``_ssd_chunked``,
``wkv_chunked`` / ``wkv_recurrence``); the card's kernels and their
backward kernels are held to these on the card by ``chip_smoke.py``.
"""
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
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-4


class _GradOut:
    """An optimizer whose step returns the gradient as the new parameters:
    the train step's gradient, read through its own code path."""

    def __init__(self, init):
        self.init = init

    def step(self, params, grads, state, **kw):
        return grads, state


# how far each constant leaf of the reference's init is drawn from its
# constant.  RWKV6's at 0.05: drawn at 0.2 (as the serve parity tests draw
# them) the reduced stack's gradient is so sensitive that two fp32
# evaluations of the port alone, the chunked WKV against the per-step
# one, differ by 1.9e-4 of a leaf's max |g| (a 1e-6 relative change of
# the parameters moves it by 4.5e-4), and no fp32 comparison holds 1e-5;
# at 0.05 every path still acts
DRAW = {"zamba2-1.2b": 0.2, "rwkv6-7b": 0.05}


def _reduced_pair(arch, seed=0):
    rcfg = ref_get_config(arch).reduced()
    ref = ref_build_model(rcfg)
    rng = np.random.RandomState(seed)

    def draw(v):
        v = np.asarray(v)
        if np.all(v == v.flat[0]):
            v = v + rng.randn(*v.shape).astype(v.dtype) * DRAW[arch]
        return np.array(v)
    rparams = jax.tree.map(draw, jax.device_get(ref.init(
        jax.random.key(seed))))
    if "mamba" in rparams:
        # softplus(dt_bias) near 0.05, in Mamba2's own dt init range: the
        # reference's chunked SSD takes exp above the diagonal before it
        # masks, and a chunk whose decay span passes ~88 gives it a NaN
        # gradient (the drawn dt_bias near 0 reached spans of 211 here;
        # the port masks first, test_torch_scan_grad.py holds that)
        rparams["mamba"]["dt_bias"] = rparams["mamba"]["dt_bias"] - 3.0
    model = build_model(get_config(arch).reduced())
    return ref, rparams, model, lm_params_from_jax(rparams, rcfg.num_layers)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_weighted_loss_gradient_matches_jax_grad(arch, monkeypatch):
    """S 70: past RWKV's switch to the chunked form at S > 64, and ragged
    against zamba2-reduced's chunk of 32; silo 1 has weight 0."""
    ref, rparams, model, params = _reduced_pair(arch)
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
                                                   rel=GRAD_TOL)
    got, ref_leaves = tree_leaves(new.params), tree_leaves(want)
    assert len(got) == len(ref_leaves)
    for g, r in zip(got, ref_leaves):
        assert g.shape == r.shape
        bound = GRAD_TOL * max(1.0, float(r.abs().max()))
        assert float((g - r).abs().max()) <= bound
    assert all(bool(g.abs().max() > 0) for g in got)


def driver_matches_reference(arch, monkeypatch, rounds=2):
    """``repro_torch.launch.train.main`` against ``repro.launch.train.main``
    at ``--scale 10m`` over ``rounds`` rounds of 4 silos x 4 x 32, from
    the reference's parameters and its explore uniforms."""
    argv = ["--arch", arch, "--scale", "10m", "--rounds", str(rounds),
            "--silos", "4", "--seq-len", "32", "--log-every", "1",
            "--seed", "0"]
    want = {"loss": [], "selected": [], "received": [], "epsilon": []}

    class JaxRecording:
        """``jax`` as the reference's driver sees it, with a ``jit`` that
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
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    ref_train.main()

    import dataclasses
    cfg = dataclasses.replace(ref_get_config(arch), name=f"{arch}-10m",
                              param_dtype="float32", compute_dtype="float32",
                              **ref_train.SCALES["10m"])
    rparams = ref_build_model(cfg).init(jax.random.key(0))
    params = lm_params_from_jax(jax.device_get(rparams), cfg.num_layers)
    uniforms, rng = [], jax.random.key(1)        # key(seed + 1)
    for _ in range(rounds):
        rng, k1 = jax.random.split(rng)
        uniforms.append(torch.from_numpy(np.array(
            jax.random.uniform(k1, (4,)))))
    state, log = T.main(argv + ["--device", "cpu"], params=params,
                        explore_uniforms=lambda rnd: uniforms[rnd])
    assert [r["selected"] for r in log] == want["selected"]
    assert [r["received"] for r in log] == want["received"]
    assert [r["epsilon"] for r in log] == want["epsilon"]
    np.testing.assert_allclose([r["loss"] for r in log], want["loss"],
                               rtol=LOSS_RTOL)
    assert int(state.step) == rounds
    assert sum(want["received"]) > 0


def test_zamba2_driver_matches_reference(monkeypatch):
    driver_matches_reference("zamba2-1.2b", monkeypatch)
