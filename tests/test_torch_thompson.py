"""Thompson selection in the port (``FLConfig.selection_mode="thompson"``)
against the JAX reference, on the CPU.

Both engines start from one template and the reference's random numbers.
Under Thompson the reference splits each round's key first,
``(k', k_ts) = split(k)``: the Beta draws come from ``k_ts`` and the
explore uniforms from ``k'``.  The port takes both through its noise
seams (``explore_uniforms`` and ``thompson_draws``), walked here from the
reference's keys; the draws depend on the beliefs the trajectory sets,
so the seam hands them in.  Integers must be equal, wall clock and comm
within 1e-5, accuracy within 4/2048.  Also: the port's own sampler
against ``scipy.stats.beta``, and the reference's concentration and
variety properties of Thompson selection.
"""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from repro.configs.base import FLConfig as RefFLConfig
from repro.data.synthetic import federated_classification as ref_data
from repro.fl import FleetEngine as RefEngine
from repro.fl import classifier as RefCLF
from repro.fl.runner import run_fl as ref_run_fl
from repro.fl.simulator import SimConfig as RefSimConfig

from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import caching as C
from repro_torch.core import dependability as D
from repro_torch.core import round as RC
from repro_torch.core import selection as SE
from repro_torch.data.synthetic import federated_classification
from repro_torch.fl import FleetEngine, SimConfig

from torch_dynamics_ref import reference_noise

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "history_prerefactor.json"
ACC_TOL = 4 / 2048


class ThompsonKeys:
    """The reference's per-round keys under Thompson: ``rng = key(seed)``,
    each round ``rng, k = split(rng)``, then ``k', k_ts = split(k)``.
    ``uniforms(rnd)`` is ``uniform(k', (N,))``; ``draws(rnd, alpha,
    beta)`` is ``beta(k_ts, alpha, beta)`` of the beliefs handed in, and
    is logged."""

    def __init__(self, seed: int, rounds: int, n: int):
        rng = jax.random.key(seed)
        self.n = n
        self.keys = []
        for _ in range(rounds):
            rng, k = jax.random.split(rng)
            self.keys.append(jax.random.split(k))
        self.calls = []

    def uniforms(self, rnd):
        return np.asarray(jax.random.uniform(self.keys[rnd][0], (self.n,)))

    def draws(self, rnd, alpha, beta):
        self.calls.append(rnd)
        return np.asarray(jax.random.beta(
            self.keys[rnd][1], alpha.cpu().numpy(), beta.cpu().numpy()))


def _template(seed, dim, num_classes, sim):
    return params_from_jax(jax.device_get(RefCLF.init_classifier(
        jax.random.key(seed + 1), dim=dim, num_classes=num_classes,
        hidden=sim.model_hidden, depth=sim.model_depth)))


def _same_trajectory(ref, ours):
    assert ours.selected == ref.selected
    assert ours.received == ref.received
    assert ours.eval_mask == ref.eval_mask
    np.testing.assert_allclose(ours.wall_clock, ref.wall_clock, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ours.comm_mb, ref.comm_mb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours.acc, ref.acc, rtol=0, atol=ACC_TOL)
    np.testing.assert_array_equal(ours.part_count,
                                  np.asarray(ref.part_count))


@pytest.fixture(scope="module")
def golden_thompson():
    g = json.loads(GOLDEN.read_text())
    sim = dict(num_clients=g["sim"]["num_clients"], rounds=g["sim"]["rounds"],
               seed=g["sim"]["seed"], local_steps=g["sim"]["local_steps"])
    fl = dict(num_clients=g["fl"]["num_clients"],
              clients_per_round=g["fl"]["clients_per_round"],
              selection_mode="thompson")
    dkw = dict(seed=g["data"]["seed"], margin=g["data"]["margin"],
               noise=g["data"]["noise"],
               n_per_client=g["data"]["n_per_client"])
    n = sim["num_clients"]
    rdata = ref_data(n, **dkw)
    ref = ref_run_fl("flude", rdata, RefSimConfig(**sim), RefFLConfig(**fl))
    sim_cfg = SimConfig(**sim)
    keys = ThompsonKeys(sim_cfg.seed, sim_cfg.rounds, n)
    engine = FleetEngine(federated_classification(n, **dkw), sim_cfg,
                         FLConfig(**fl),
                         template=_template(sim_cfg.seed, rdata.x.shape[-1],
                                            rdata.num_classes, sim_cfg),
                         device="cpu")
    ours = engine.run("flude", explore_uniforms=keys.uniforms,
                      thompson_draws=keys.draws)
    return ref, ours, keys


def test_golden_setup_matches_reference_under_thompson(golden_thompson):
    ref, ours, keys = golden_thompson
    _same_trajectory(ref, ours)
    # one draw a round, and the budget loop (none here) reuses it
    assert keys.calls == list(range(len(ours.acc)))


N, ROUNDS = 24, 5
SIM = dict(num_clients=N, rounds=ROUNDS, seed=3, local_steps=2)
DATA = dict(seed=2, n_per_client=32)


@pytest.mark.parametrize("cohort", [None, 8], ids=["full_scan", "cohort8"])
def test_device_loop_matches_reference_under_thompson(cohort):
    """markov churn on the device loop, with and without a compact
    cohort of X = 8."""
    fl = dict(num_clients=N, clients_per_round=8, dynamics="markov",
              selection_mode="thompson", cohort_size=cohort)
    ref = RefEngine(ref_data(N, **DATA), RefSimConfig(**SIM),
                    RefFLConfig(**fl)).run("flude")
    sim = SimConfig(**SIM)
    keys = ThompsonKeys(sim.seed, ROUNDS, N)
    noise = reference_noise("markov", sim.seed, ROUNDS, N)
    port = FleetEngine(federated_classification(N, **DATA), sim,
                       FLConfig(**fl), template=_template(sim.seed, 32, 10,
                                                          sim),
                       device="cpu")
    ours = port.run("flude", explore_uniforms=keys.uniforms,
                    thompson_draws=keys.draws,
                    dynamics_noise=lambda r: noise[r])
    _same_trajectory(ref, ours)
    assert keys.calls == list(range(ROUNDS))


@pytest.mark.parametrize("alpha,beta", [(2.0, 2.0), (0.7, 3.5),
                                        (40.0, 6.0)])
def test_port_sampler_is_beta_distributed(alpha, beta):
    """The engine's default sampler, Ga(α) / (Ga(α) + Ga(β)) from a
    seeded generator, against scipy's Beta(α, β): a Kolmogorov-Smirnov
    test of 20,000 draws at level 0.001."""
    n = 20_000
    gen = torch.Generator().manual_seed(11)
    belief = D.BetaBelief(torch.full((n,), alpha), torch.full((n,), beta))
    draws = D.sample_dependability(belief, gen)
    assert draws.dtype == torch.float32 and draws.shape == (n,)
    assert bool(((draws >= 0) & (draws <= 1)).all())
    res = stats.kstest(draws.numpy(), stats.beta(alpha, beta).cdf)
    assert res.pvalue > 1e-3, res
    # a seeded generator reproduces its draws
    again = D.sample_dependability(
        belief, torch.Generator().manual_seed(11))
    assert torch.equal(draws, again)


def _belief(dep, n=1000.0):
    dep = torch.as_tensor(dep, dtype=torch.float32)
    return D.update_belief(D.init_belief(dep.shape[0], 0.0, 0.0),
                           dep * n, (1 - dep) * n)


def _select(b, X, seed, explored=True):
    N = b.alpha.shape[0]
    gen = torch.Generator().manual_seed(seed)
    draws = D.sample_dependability(b, gen)
    return SE.select_participants(
        b, torch.zeros((N,), dtype=torch.int32),
        torch.full((N,), explored), torch.ones((N,), dtype=torch.bool),
        torch.tensor(0.0), torch.tensor(X), torch.tensor(0.0), 0.5,
        torch.rand((N,), generator=gen), thompson_draws=draws)


def test_thompson_selection_valid_and_stochastic():
    """The reference's property: |S| = X every draw, the selection varies
    with the draws, and dependable devices are still preferred."""
    N = 32
    b = _belief(torch.linspace(0.1, 0.9, N), n=5.0)     # wide posteriors
    sels = []
    for seed in range(6):
        res = _select(b, 8, seed)
        assert int(res.selected.sum()) == 8
        sels.append(res.selected.numpy())
    assert any(not (sels[0] == s).all() for s in sels[1:])
    freq = np.stack(sels).mean(0)
    assert freq[-8:].mean() > freq[:8].mean()


def test_thompson_concentrates_with_evidence():
    """With tight posteriors Thompson ranks as the posterior mean does."""
    N = 16
    b = _belief(torch.linspace(0.05, 0.95, N), n=5000.0)
    res = _select(b, 4, 0)
    assert bool(res.selected[-4:].all())


def test_thompson_mode_needs_its_draws():
    """The plan takes the round's draws exactly under "thompson"."""
    N = 4
    online, uniforms = torch.ones((N,), dtype=torch.bool), torch.rand(N)
    draws = D.sample_dependability(_belief(torch.linspace(0.1, 0.9, N)),
                                   torch.Generator().manual_seed(0))
    for mode, given in (("thompson", None), ("mean", draws)):
        cfg = FLConfig(num_clients=N, clients_per_round=2,
                       selection_mode=mode)
        caches = C.init_caches({}, N, device="cpu")
        with pytest.raises(ValueError, match="thompson_draws"):
            RC.plan_round(RC.init_state(cfg), caches, online, cfg,
                          uniforms, thompson_draws=given)


def test_default_sampler_reproduces_and_differs_from_mean():
    """Without handed-in draws the engine samples on its device from a
    generator seeded by sim_cfg.seed: a rerun repeats the run, another
    seed or the posterior mean gives another one.  Under a finite comm
    budget the budget loop reuses the round's draws (one call a
    round)."""
    data = federated_classification(32, seed=0, n_per_client=32)
    runs = {}
    for label, mode, seed in (("a", "thompson", 0), ("b", "thompson", 0),
                              ("c", "thompson", 1), ("mean", "mean", 0)):
        sim = SimConfig(num_clients=32, rounds=8, seed=seed, local_steps=2)
        fl = FLConfig(num_clients=32, clients_per_round=8,
                      dynamics="bernoulli", selection_mode=mode,
                      epsilon_init=0.2)
        runs[label] = FleetEngine(data, sim, fl, device="cpu").run(
            "flude", diagnostics=False).to_json()
    assert runs["a"] == runs["b"]
    assert runs["a"]["selected"] != runs["c"]["selected"] \
        or runs["a"]["received"] != runs["c"]["received"]
    assert runs["a"] != runs["mean"]

    calls = []
    sim = SimConfig(num_clients=32, rounds=3, seed=0, local_steps=2)
    fl = FLConfig(num_clients=32, clients_per_round=8,
                  selection_mode="thompson", comm_budget=6.0)

    def draws(rnd, alpha, beta):
        calls.append(rnd)
        return D.sample_dependability(D.BetaBelief(alpha, beta),
                                      torch.Generator().manual_seed(rnd))
    FleetEngine(data, sim, fl, device="cpu").run(
        "flude", thompson_draws=draws, diagnostics=False)
    assert calls == [0, 1, 2]
