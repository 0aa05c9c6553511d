"""The port's device round loop (``FLConfig.dynamics`` a device process)
against the JAX reference's ``_device_rounds``, on the CPU.

Both engines start from one template and the reference's random numbers:
its explore uniforms and its dynamics uniforms, walked from its
``jax.random`` keys (``torch_dynamics_ref``).  The integer trajectory
must be equal, the floats within the stated tolerances.  Also: History
rows are the same at every ``pipeline_depth``, ``bernoulli_host`` stays on
the host loop, the rounds upload nothing, and the configs accept what
this slice runs.
"""
import jax
import numpy as np
import pytest

from repro.configs.base import FLConfig as RefFLConfig
from repro.data.synthetic import federated_classification as ref_data
from repro.fl import FleetEngine as RefEngine
from repro.fl import classifier as RefCLF
from repro.fl.simulator import SimConfig as RefSimConfig
from repro.fleet import apply_scenario as ref_apply_scenario

import repro_torch.fl.engine as ENG
from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import federated_classification
from repro_torch.fl import FleetEngine, SimConfig
from repro_torch.fleet import apply_scenario

from torch_dynamics_ref import reference_explore_uniforms, reference_noise

N, ROUNDS = 24, 5
SIM = dict(num_clients=N, rounds=ROUNDS, seed=3, local_steps=2)
FL = dict(num_clients=N, clients_per_round=8)
DATA = dict(seed=2, n_per_client=32)
# accuracy is over 2048 test samples: a few flipped predictions from fp32
# rounding differences in local SGD are tolerated
ACC_TOL = 4 / 2048
POLICIES = ["flude", "random", "oort", "safa", "fedsea", "mifa",
            "asyncfeded"]
# (label, FLConfig changes): the four device processes at their default
# parameters and the diurnal scenario (heavy-tailed sessions, day/night
# gaps, undep mixing)
DYNAMICS = [("bernoulli", dict(dynamics="bernoulli")),
            ("markov", dict(dynamics="markov")),
            ("sessions", dict(dynamics="sessions")),
            ("trace", dict(dynamics="trace")),
            ("diurnal", "diurnal")]


def _configs(change, sim_extra=None):
    sim = dict(SIM, **(sim_extra or {}))
    if isinstance(change, str):
        fl = apply_scenario(FLConfig(**FL), change)
        rfl = ref_apply_scenario(RefFLConfig(**FL), change)
    else:
        fl, rfl = FLConfig(**FL, **change), RefFLConfig(**FL, **change)
    return sim, fl, rfl


class Pair:
    """One reference engine and one port engine on the same data,
    template and random numbers; runs are memoized per policy."""

    def __init__(self, change, sim_extra=None):
        sim, fl, rfl = _configs(change, sim_extra)
        self.ref = RefEngine(ref_data(N, **DATA), RefSimConfig(**sim), rfl)
        template = jax.device_get(RefCLF.init_classifier(
            jax.random.key(sim["seed"] + 1), dim=32, num_classes=10,
            hidden=128, depth=2))
        self.port = FleetEngine(federated_classification(N, **DATA),
                                SimConfig(**sim), fl,
                                template=params_from_jax(template),
                                device="cpu")
        self.us = reference_explore_uniforms(sim["seed"], ROUNDS, N)
        self.noise = reference_noise(fl.dynamics, sim["seed"], ROUNDS, N)
        self.runs = {}

    def run(self, policy, **kw):
        key = (policy, tuple(sorted(kw.items())))
        if key not in self.runs:
            ref = self.ref.run(policy, **kw)
            ours = self.port.run(policy, explore_uniforms=lambda r: self.us[r],
                                 dynamics_noise=lambda r: self.noise[r], **kw)
            self.runs[key] = (ref, ours)
        return self.runs[key]


@pytest.fixture(scope="module")
def pairs():
    """Engines built on first use and shared by the module's tests, so
    the reference compiles each once."""
    cache = {}

    def get(label):
        if label not in cache:
            change = dict(DYNAMICS)[label] if label in dict(DYNAMICS) \
                else label
            cache[label] = Pair(change)
        return cache[label]
    return get


def _same_trajectory(ref, ours):
    assert ours.selected == ref.selected
    assert ours.received == ref.received
    assert ours.eval_mask == ref.eval_mask
    np.testing.assert_allclose(ours.wall_clock, ref.wall_clock, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ours.comm_mb, ref.comm_mb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours.acc, ref.acc, rtol=0, atol=ACC_TOL)
    if ref.part_count is None:
        assert ours.part_count is None
    else:
        np.testing.assert_array_equal(ours.part_count,
                                      np.asarray(ref.part_count))


@pytest.mark.parametrize("label", [d[0] for d in DYNAMICS])
def test_flude_matches_reference_under_each_process(pairs, label):
    ref, ours = pairs(label).run("flude")
    _same_trajectory(ref, ours)
    assert len(ours.acc) == ROUNDS


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_reference_under_bernoulli(pairs, policy):
    ref, ours = pairs("bernoulli").run(policy)
    _same_trajectory(ref, ours)


def test_flude_under_sign_flip_with_geometric_median():
    """The robust run of the dynamics phase: the sign-flip-20 scenario
    (bernoulli availability, 20% reverse attack) aggregated by the
    geometric median."""
    sim, fl, rfl = _configs("sign-flip-20")
    pair = Pair(dict(dynamics=fl.dynamics, adversary=fl.adversary,
                     adversary_params=fl.adversary_params,
                     agg_rule="geometric_median"))
    ref, ours = pair.run("flude")
    _same_trajectory(ref, ours)


@pytest.mark.parametrize("change,extra", [
    (dict(dynamics="markov"), dict(round_deadline=20.3)),
    (dict(dynamics="sessions"), dict(round_deadline=17.1)),
], ids=["deadline-20.3", "deadline-17.1"])
def test_capped_rounds_bill_the_exact_deadline(change, extra):
    """A deadline with no float32 value: capped rounds come back as a flag
    and the ledger bills the configured float64 deadline, as the
    reference's does."""
    ref, ours = Pair(change, extra).run("flude")
    _same_trajectory(ref, ours)
    steps = np.diff([0.0] + ours.wall_clock)
    capped = steps == extra["round_deadline"]
    assert capped.any() and not capped.all(), steps


@pytest.mark.parametrize("kw", [dict(eval_every=2), dict(time_budget=200.0),
                                dict(rounds=3)],
                         ids=["eval_every", "time_budget", "rounds"])
def test_ledger_cadence_matches_reference(pairs, kw):
    ref, ours = pairs("markov").run("flude", **kw)
    _same_trajectory(ref, ours)
    # the 200 s budget ends the run after its third round
    assert len(ours.acc) == {"eval_every": ROUNDS, "time_budget": 3,
                             "rounds": 3}[next(iter(kw))]


@pytest.mark.parametrize("policy", POLICIES)
def test_pipeline_depth_gives_identical_rows(policy):
    """Depths 1, 2 and 4 (past the 3 rounds: the run-end flush) give
    the same History, to the bit."""
    data = federated_classification(16, seed=0, n_per_client=32)
    sim = SimConfig(num_clients=16, rounds=3, seed=0, local_steps=2)
    rows = []
    for depth in (1, 2, 4):
        fl = apply_scenario(FLConfig(num_clients=16, clients_per_round=8,
                                     pipeline_depth=depth), "churn")
        hist = FleetEngine(data, sim, fl, device="cpu").run(
            policy, diagnostics=False)
        rows.append(hist.to_json())
    assert rows[0] == rows[1] == rows[2]
    assert len(rows[0]["acc"]) == 3


def test_progress_ticks_and_depth_agree():
    data = federated_classification(16, seed=0, n_per_client=32)
    sim = SimConfig(num_clients=16, rounds=12, seed=0, local_steps=2)
    out = {}
    for depth in (1, 3):
        ticks = []
        fl = FLConfig(num_clients=16, clients_per_round=8,
                      dynamics="sessions", pipeline_depth=depth)
        hist = FleetEngine(data, sim, fl, device="cpu").run(
            "flude", diagnostics=False,
            progress=lambda *a: ticks.append(a))
        out[depth] = (hist.to_json(), ticks)
    assert out[1] == out[3]
    assert [t[0] for t in out[1][1]] == [0, 10, 11]


def test_bernoulli_host_stays_on_the_host_loop(monkeypatch):
    """The default and an explicit ``bernoulli_host`` run the host loop,
    unchanged; every other process goes to the device loop."""
    data = federated_classification(16, seed=0, n_per_client=32)
    sim = SimConfig(num_clients=16, rounds=2, seed=0, local_steps=2)
    default = FleetEngine(data, sim, FLConfig(num_clients=16),
                          device="cpu").run("flude")

    def refuse(*a, **k):
        raise AssertionError("the device loop ran")
    monkeypatch.setattr(ENG.FleetEngine, "_device_rounds", refuse)
    explicit = FleetEngine(data, sim, FLConfig(num_clients=16,
                                               dynamics="bernoulli_host"),
                           device="cpu").run("flude")
    assert explicit.to_json() == default.to_json()
    with pytest.raises(AssertionError, match="device loop"):
        FleetEngine(data, sim, FLConfig(num_clients=16, dynamics="markov"),
                    device="cpu").run("flude")


def test_device_loop_keeps_state_and_uploads_nothing_per_round(monkeypatch):
    """Placements on the device are per engine or per run, never per
    round, and the run's final process state and draw stay on the
    engine."""
    counts = {"n": 0}
    orig = ENG.place_per_client

    def counting(arr, device):
        counts["n"] += 1
        return orig(arr, device)
    monkeypatch.setattr(ENG, "place_per_client", counting)
    data = federated_classification(16, seed=0, n_per_client=32)
    sim = SimConfig(num_clients=16, rounds=5, seed=0, local_steps=2)
    engine = FleetEngine(data, sim, FLConfig(num_clients=16,
                                             clients_per_round=8,
                                             dynamics="markov"),
                         device="cpu")
    first = engine.run("flude", rounds=1)
    per_run = []
    for rounds in (1, 5):
        counts["n"] = 0
        again = engine.run("flude", rounds=rounds)
        per_run.append(counts["n"])
    assert per_run == [0, 0], per_run
    assert again.to_json()["selected"][:1] == first.selected
    assert engine._last_draw.online.shape == (16,)
    assert engine._last_fleet_state.slot.shape == (16,)
    assert int(engine._last_fleet_state.t) == 5


@pytest.mark.parametrize("change", [
    dict(dynamics="markov"), dict(dynamics="sessions", pipeline_depth=3),
    dict(dynamics="trace", dynamics_params=(("horizon", 12.0),)),
    dict(pipeline_depth=2), dict(telemetry="basic"),
    dict(debug_checks=True),
    dict(dynamics="markov", cohort_size=8, selection_mode="thompson")])
def test_flconfig_accepts_what_the_slice_runs(change):
    FLConfig(num_clients=16, **change)


@pytest.mark.parametrize("change,item", [
    (dict(mesh_shape=(2,)), "#17"), (dict(donate_buffers=True), "#17")],
    ids=["mesh_shape", "donate_buffers"])
def test_refusals_still_standing_name_their_items(change, item):
    with pytest.raises(NotImplementedError, match=item):
        FLConfig(num_clients=16, **change)


def test_default_noise_reproduces_and_differs_by_seed():
    data = federated_classification(16, seed=0, n_per_client=32)
    fl = FLConfig(num_clients=16, clients_per_round=8, dynamics="sessions")
    runs = []
    for seed in (0, 0, 1):
        sim = SimConfig(num_clients=16, rounds=4, seed=seed, local_steps=2)
        runs.append(FleetEngine(data, sim, fl, device="cpu").run(
            "flude", diagnostics=False).to_json())
    assert runs[0] == runs[1]
    assert runs[0]["selected"] != runs[2]["selected"] \
        or runs[0]["received"] != runs[2]["received"]
