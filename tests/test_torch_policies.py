"""The port's six baseline policies against the JAX reference.

Each baseline (random, oort, safa, fedsea, mifa, asyncfeded) runs the
golden setup of ``tests/golden/history_prerefactor.json`` (N = 24, 8 per
round, 5 rounds) through JAX's ``run_fl`` live in this process and
through ``repro_torch``'s engine on the CPU, with the reference's initial
model carried over.  The baselines draw from host ``np.random.RandomState``
seeded as in the reference, so the integer trajectory must be equal and
the floats within fp32 summation-order tolerance.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.configs.base import FLConfig as RefFLConfig
from repro.data.synthetic import federated_classification as ref_data
from repro.fl import classifier as RefCLF
from repro.fl.api import RoundObservation as RefObs
from repro.fl.api import RoundReport as RefReport
from repro.fl.api import available_policies as ref_policies
from repro.fl.api import make_policy as ref_mk
from repro.fl.runner import run_fl as ref_run_fl
from repro.fl.simulator import Fleet as RefFleet, SimConfig as RefSimConfig

from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import caching as C
from repro_torch.data.synthetic import federated_classification
from repro_torch.fl import (FleetEngine, RoundObservation, RoundReport,
                            available_policies, make_policy)
from repro_torch.fl.simulator import Fleet, SimConfig

GOLDEN = pathlib.Path(__file__).resolve().parents[1] / "tests" / "golden" \
    / "history_prerefactor.json"
# accuracy is over 2048 test samples: a few flipped predictions from fp32
# rounding differences in five rounds of local SGD are tolerated
ACC_TOL = 4 / 2048
BASELINES = ["random", "oort", "safa", "fedsea", "mifa", "asyncfeded"]


def _golden_setup():
    g = json.loads(GOLDEN.read_text())
    sim = dict(num_clients=g["sim"]["num_clients"], rounds=g["sim"]["rounds"],
               seed=g["sim"]["seed"], local_steps=g["sim"]["local_steps"])
    fl = dict(num_clients=g["fl"]["num_clients"],
              clients_per_round=g["fl"]["clients_per_round"])
    data = dict(seed=g["data"]["seed"], margin=g["data"]["margin"],
                noise=g["data"]["noise"],
                n_per_client=g["data"]["n_per_client"])
    return sim, fl, data


def test_the_port_registers_every_reference_policy():
    assert available_policies() == sorted(ref_policies())


@pytest.mark.parametrize("policy", BASELINES)
def test_baseline_matches_reference_trajectory(policy):
    sim, fl, dkw = _golden_setup()
    n = sim["num_clients"]
    rdata = ref_data(n, **dkw)
    ref = ref_run_fl(policy, rdata, RefSimConfig(**sim), RefFLConfig(**fl))
    sim_cfg = SimConfig(**sim)
    template = jax.device_get(RefCLF.init_classifier(
        jax.random.key(sim_cfg.seed + 1), dim=rdata.x.shape[-1],
        num_classes=rdata.num_classes, hidden=sim_cfg.model_hidden,
        depth=sim_cfg.model_depth))
    port = FleetEngine(federated_classification(n, **dkw), sim_cfg,
                       FLConfig(**fl), template=params_from_jax(template),
                       device="cpu").run(policy)
    assert port.selected == ref.selected
    assert port.received == ref.received
    assert port.part_count is None and ref.part_count is None
    np.testing.assert_allclose(port.wall_clock, ref.wall_clock, atol=1e-5)
    np.testing.assert_allclose(port.comm_mb, ref.comm_mb, atol=1e-5)
    np.testing.assert_allclose(port.acc, ref.acc, atol=ACC_TOL)
    assert port.eval_mask == ref.eval_mask


@pytest.mark.parametrize("policy", BASELINES)
def test_baseline_plans_match_reference_plans(policy):
    """Plan by plan over rounds with random online masks, caches and
    reports: the same masks, quorum, step counts and weights."""
    n = 30
    sim = dict(num_clients=n, seed=11, local_steps=4)
    fl = dict(num_clients=n, clients_per_round=7)
    ours = make_policy(policy, SimConfig(**sim), FLConfig(**fl),
                       Fleet(SimConfig(**sim)))
    theirs = ref_mk(policy, RefSimConfig(**sim), RefFLConfig(**fl),
                    RefFleet(RefSimConfig(**sim)))
    s, rs = ours.init_state(), theirs.init_state()
    rng = np.random.RandomState(0)
    key = jax.random.key(0)
    for rnd in range(6):
        online = rng.rand(n) < 0.6
        stamp = rng.randint(-1, rnd + 1, n).astype(np.int32)
        caches = C.ClientCaches({}, torch.zeros(n), torch.from_numpy(stamp))
        rcaches = ref_core.ClientCaches({}, jnp.zeros(n), jnp.asarray(stamp))
        s, p = ours.plan(s, RoundObservation(rnd, online, caches))
        rs, q = theirs.plan(rs, RefObs(rnd, online, rcaches), key)
        for name in ("selected", "distribute", "resume"):
            np.testing.assert_array_equal(np.asarray(getattr(p, name)),
                                          np.asarray(getattr(q, name)))
        assert p.quorum == q.quorum
        for name in ("steps_override", "agg_weights"):
            a, b = getattr(p, name), getattr(q, name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        sel = np.asarray(p.selected)
        received = sel & (rng.rand(n) < 0.7)
        report = dict(received=received, fail=sel & ~received,
                      losses=rng.rand(n).astype(np.float32),
                      durations=np.where(received, rng.rand(n) * 600,
                                         np.inf),
                      duration=600.0, rnd=rnd)
        s = ours.observe(s, p, RoundReport(**report))
        rs = theirs.observe(rs, q, RefReport(**report))


@pytest.mark.parametrize("policy", ["oort", "fedsea"])
def test_speed_aware_baselines_need_the_fleet(policy):
    with pytest.raises(ValueError, match="fleet"):
        make_policy(policy, SimConfig(num_clients=4), FLConfig(num_clients=4))
