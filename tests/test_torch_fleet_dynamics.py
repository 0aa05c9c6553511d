"""The port's fleet dynamics (``repro_torch.fleet``), its device round cut
and its dynamics trainer against the JAX reference, on the CPU.

The processes take their uniforms as named inputs; the reference's are
walked from its ``jax.random`` keys (``torch_dynamics_ref``), so both
packages run the same draws and the online masks must be equal.  Floats
that pass through ``log1p``, ``exp``, ``pow`` or ``cos`` may differ in
the last ulp between XLA and torch, hence the stated tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro import fleet as ref_fleet
from repro.configs.base import FLConfig as RefFLConfig
from repro.data.synthetic import federated_classification as ref_data
from repro.fl import classifier as RefCLF
from repro.fl.engine import make_trainer as ref_make_trainer
from repro.fl.simulator import Fleet as RefFleet, SimConfig as RefSimConfig
from repro.fleet.api import FleetDraw as RefDraw
from repro.fleet.scenarios import _REGISTRY as REF_SCENARIOS

from repro_torch import fleet as F
from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import caching as C
from repro_torch.core import round as R
from repro_torch.data.synthetic import federated_classification
from repro_torch.fl.api import RoundPlan
from repro_torch.fl.engine import make_trainer
from repro_torch.fl.simulator import Fleet, SimConfig
from repro_torch.fleet import api as FAPI
from repro_torch.fleet import scenarios as FSCN

from torch_dynamics_ref import reference_keys, reference_noise

# (process, FLConfig.dynamics_params): the four device processes, the
# scenario presets' parameterizations of sessions and trace among them
PROCESSES = [
    ("bernoulli", ()),
    ("markov", (("mean_on", 5.0),)),
    ("sessions", ()),
    ("sessions", FSCN.get_scenario("diurnal").params),
    ("trace", ()),
    ("trace", FSCN.get_scenario("flash-crowd").params),
    ("trace", FSCN.get_scenario("correlated-dropout").params),
]
PROCESS_IDS = ["bernoulli", "markov-churn", "sessions", "sessions-diurnal",
               "trace", "trace-flash-crowd", "trace-correlated-dropout"]
FEATURES = ("undep", "online_rate", "steps_per_sec", "bandwidth", "battery",
            "stability")


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_the_port_registers_every_reference_process_and_scenario():
    assert F.available_dynamics() == ref_fleet.available_dynamics()
    assert F.available_scenarios() == ref_fleet.available_scenarios()
    assert F.get_dynamics("bernoulli_host").host_side
    for name in ("bernoulli", "markov", "sessions", "trace"):
        assert not F.get_dynamics(name).host_side


@pytest.mark.parametrize("kind", ["dynamics", "scenario"])
def test_registries_reject_unknown_and_duplicate_names(kind):
    if kind == "dynamics":
        with pytest.raises(KeyError, match="unknown dynamics 'nope'"):
            F.get_dynamics("nope")

        @F.register_dynamics("_test_dyn")
        class Dummy(F.DynamicsProcess):
            pass
        try:
            assert F.get_dynamics("_test_dyn") is Dummy
            with pytest.raises(ValueError, match="already registered"):
                F.register_dynamics("_test_dyn")(Dummy)
            with pytest.raises(TypeError):
                F.register_dynamics("_test_fn")(lambda: None)
        finally:
            FAPI._REGISTRY.pop("_test_dyn", None)
    else:
        with pytest.raises(KeyError, match="unknown scenario 'nope'"):
            F.get_scenario("nope")
        with pytest.raises(ValueError, match="already registered"):
            F.register_scenario(F.get_scenario("churn"))
        with pytest.raises(KeyError):
            F.Scenario("_bad", "no-such-process").apply(FLConfig())


@pytest.mark.parametrize("name", sorted(REF_SCENARIOS))
def test_every_scenario_preset_resolves(name):
    """Each preset installs the reference's dynamics and attack into a
    port FLConfig, and its process builds on a small fleet."""
    ours = F.apply_scenario(FLConfig(num_clients=16), name)
    theirs = ref_fleet.apply_scenario(RefFLConfig(num_clients=16), name)
    for field in ("dynamics", "dynamics_params", "adversary",
                  "adversary_params"):
        assert getattr(ours, field) == getattr(theirs, field), field
    sim = SimConfig(num_clients=16, seed=1)
    proc = F.make_dynamics(ours.dynamics, sim, fleet=Fleet(sim),
                           params=ours.dynamics_params)
    assert proc.host_side == (name == "paper")


def test_fleet_features_copy_the_reference():
    sim = dict(num_clients=40, seed=7)
    ours = Fleet(SimConfig(**sim)).features("cpu")
    theirs = RefFleet(RefSimConfig(**sim)).features()
    for name in FEATURES:
        got = getattr(ours, name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(theirs, name)))
    assert ours.num_clients == 40


@pytest.mark.parametrize("name,params", PROCESSES, ids=PROCESS_IDS)
def test_process_matches_reference(name, params):
    """20 rounds of one process from the reference's uniforms: online
    masks and the handed-in variates exact, fail_p within 1e-6, the
    sessions clocks within 1e-5 of max(1, |x|) rounds (a remaining time
    near zero is the difference of a session length and whole rounds and
    keeps the length's rounding), the Markov state exact."""
    n, rounds, seed = 64, 20, 3
    sim = dict(num_clients=n, seed=seed)
    ref = ref_fleet.make_dynamics(
        name, RefSimConfig(**sim), fleet=RefFleet(RefSimConfig(**sim)),
        params=params)
    ours = F.make_dynamics(name, SimConfig(**sim),
                           fleet=Fleet(SimConfig(**sim)), params=params)
    noise = reference_noise(name, seed, rounds, n)
    init_key, keys = reference_keys(seed, rounds)
    # the reference's engine jits both, as here
    rs = jax.jit(ref.init_state)(init_key)
    step = jax.jit(ref.step)
    ps = ours.init_state(_t(noise["init"]))
    for rnd in range(rounds):
        rs, rd = step(rs, keys[rnd])
        ps, pd = ours.step(ps, _t(noise[rnd]))
        for field in ("online", "fail_u", "stop_u", "bandwidth", "battery"):
            np.testing.assert_array_equal(
                getattr(pd, field).numpy(), np.asarray(getattr(rd, field)),
                err_msg=f"round {rnd} {field}")
        np.testing.assert_allclose(pd.fail_p.numpy(), np.asarray(rd.fail_p),
                                   rtol=0, atol=1e-6)
        assert int(ps.t) == int(rs.t) == rnd + 1
        if name == "markov":
            np.testing.assert_array_equal(ps.slot.numpy(),
                                          np.asarray(rs.slot))
        if name == "sessions":
            np.testing.assert_array_equal(ps.slot["on"].numpy(),
                                          np.asarray(rs.slot["on"]))
            for clock in ("remaining", "age"):
                want = np.asarray(rs.slot[clock])
                err = np.abs(ps.slot[clock].numpy() - want)
                assert (err <= 1e-5 * np.maximum(np.abs(want), 1.0)).all(), \
                    (rnd, clock, float(err.max()))


@pytest.mark.parametrize("pattern", ["diurnal", "flash-crowd",
                                     "correlated-dropout"])
@pytest.mark.parametrize("with_rate", [False, True])
def test_synthesize_trace_is_bit_equal(pattern, with_rate):
    rate = np.random.RandomState(5).uniform(0.1, 0.9, 50) \
        .astype(np.float32) if with_rate else None
    kw = dict(pattern=pattern, seed=9, online_rate=rate, period=12,
              event_rate=0.2)
    got = F.synthesize_trace(50, 70, **kw)
    want = ref_fleet.synthesize_trace(50, 70, **kw)
    assert got.dtype == want.dtype == bool and got.shape == (50, 70)
    np.testing.assert_array_equal(got, want)


def test_trace_replays_wraps_and_rejects_bad_shapes():
    n, T = 12, 5
    sim = SimConfig(num_clients=n, seed=0)
    trace = np.random.RandomState(0).rand(n, T) < 0.5
    proc = F.make_dynamics("trace", sim, fleet=Fleet(sim),
                           params=(("trace", trace),))
    online = F.simulate_availability(proc, 2 * T + 1, seed=1)
    np.testing.assert_array_equal(online.T, trace[:, np.arange(2 * T + 1)
                                                  % T])
    with pytest.raises(ValueError, match="num_clients"):
        F.make_dynamics("trace", sim, fleet=Fleet(sim),
                        params=(("trace", trace[:-1]),))
    with pytest.raises(ValueError, match="unknown trace pattern"):
        F.synthesize_trace(4, 4, pattern="nope")


@pytest.mark.parametrize("name", ["bernoulli", "markov", "sessions",
                                  "trace", "bernoulli_host"])
def test_simulate_availability_and_summary(name):
    sim = SimConfig(num_clients=30, seed=2)
    proc = F.make_dynamics(name, sim, fleet=Fleet(sim))
    online = F.simulate_availability(proc, 12, seed=4)
    assert online.shape == (12, 30) and online.dtype == bool
    again = F.simulate_availability(
        F.make_dynamics(name, sim, fleet=Fleet(sim)), 12, seed=4)
    np.testing.assert_array_equal(online, again)
    assert F.availability_summary(online) == \
        ref_fleet.availability_summary(online)


def test_markov_stationary_matches_reference():
    sim = dict(num_clients=32, seed=6)
    for mean_on in (1.0, 3.0, 8.0):
        ours = F.MarkovProcess(SimConfig(**sim), fleet=Fleet(SimConfig(**sim)),
                               mean_on=mean_on)
        theirs = ref_fleet.MarkovProcess(RefSimConfig(**sim),
                                         fleet=RefFleet(RefSimConfig(**sim)),
                                         mean_on=mean_on)
        np.testing.assert_array_equal(ours.stationary(), theirs.stationary())


# ---------------------------------------------------------------------------
# The device round cut
# ---------------------------------------------------------------------------

def _cut_times(case, n, rng):
    if case == "all inf":
        return np.full(n, np.inf, np.float32)
    t = (rng.rand(n) * 160.0).astype(np.float32)
    t[rng.rand(n) < 0.3] = np.inf
    if case == "ties at the deadline":
        t[:5] = np.float32(100.3)
        t[5:8] = np.nextafter(np.float32(100.3), np.float32(0))
    return t


@pytest.mark.parametrize("waits", [True, False], ids=["sync", "async"])
@pytest.mark.parametrize("deadline", [600.0, 100.3, 50.0])
@pytest.mark.parametrize("case", ["random", "all inf",
                                  "ties at the deadline"])
def test_round_cut_matches_reference(waits, deadline, case):
    """t_cut, received, capped and the three History counts exact over
    quorums 0, 1, 2.5, 7 and N, as a 0-d tensor and as a python number;
    the billed duration is the host cut's."""
    n = 40
    rng = np.random.RandomState(len(case) + int(deadline))
    times = _cut_times(case, n, rng)
    success = np.isfinite(times) | (rng.rand(n) < 0.1)
    online, dist, sel = (rng.rand(3, n) < 0.6)
    ours = R.make_round_cut(n, deadline, waits)
    theirs = ref_core.make_round_cut(n, deadline, waits, with_counts=True)
    for q in (0, 1, 2.5, 7, n):
        want = [np.asarray(x) for x in theirs(
            jnp.asarray(times), jnp.float32(q), jnp.asarray(success),
            jnp.asarray(online), jnp.asarray(dist), jnp.asarray(sel))]
        for quorum in (torch.tensor(q, dtype=torch.float32), q):
            got = [x.numpy() for x in ours(
                torch.from_numpy(times), quorum, torch.from_numpy(success),
                torch.from_numpy(online), torch.from_numpy(dist),
                torch.from_numpy(sel))]
            assert got[0].dtype == np.float32 and got[0].shape == ()
            for g, w, what in zip(got, want, ("t_cut", "received", "capped",
                                              "received count",
                                              "download count",
                                              "selected count")):
                np.testing.assert_array_equal(g, w, err_msg=f"q={q} {what}")
        billed = deadline if bool(got[2]) else float(got[0])
        _, duration = R.host_round_cut(times, q, deadline, waits)
        assert billed == duration


# ---------------------------------------------------------------------------
# The dynamics trainer
# ---------------------------------------------------------------------------

N_TR = 12
SIM_TR = dict(num_clients=N_TR, local_steps=5, batch_size=8, lr=0.1,
              model_hidden=16, seed=4)
DATA_TR = dict(dim=6, num_classes=4, n_per_client=20, n_test=16, seed=3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_all_dyn_matches_reference(seed):
    """Workload, exposure-scaled failure, interruption, training and the
    timing model against the reference's fused dynamics trainer:
    steps_needed, fail and success exact, times within 1e-6 relative,
    params within 1e-5."""
    rng = np.random.RandomState(seed)
    template = jax.tree.map(np.asarray, jax.device_get(
        RefCLF.init_classifier(jax.random.key(seed), dim=6, num_classes=4,
                               hidden=16, depth=2)))
    cached = jax.tree.map(
        lambda a: (rng.randn(N_TR, *a.shape) * 0.3).astype(np.float32),
        template)
    progress = rng.rand(N_TR).astype(np.float32)
    stamp = rng.randint(-1, 3, N_TR).astype(np.int32)
    selected = rng.rand(N_TR) < 0.7
    resume = selected & (rng.rand(N_TR) < 0.5)
    distribute = selected & ~resume
    base = rng.randint(0, 8, N_TR).astype(np.int32)    # some above 5
    every = rng.randint(1, 5, N_TR).astype(np.int32)
    draw = dict(online=rng.rand(N_TR) < 0.8,
                fail_p=rng.rand(N_TR).astype(np.float32),
                fail_u=rng.rand(N_TR).astype(np.float32),
                stop_u=rng.rand(N_TR).astype(np.float32),
                bandwidth=rng.uniform(1, 30, N_TR).astype(np.float32),
                battery=rng.rand(N_TR).astype(np.float32))
    rfleet = RefFleet(RefSimConfig(**SIM_TR))
    want = ref_make_trainer(RefSimConfig(**SIM_TR), ref_data(N_TR, **DATA_TR),
                            dynamics_features=rfleet.features())(
        jax.tree.map(jnp.asarray, template),
        ref_core.ClientCaches(jax.tree.map(jnp.asarray, cached),
                              jnp.asarray(progress), jnp.asarray(stamp)),
        RefDraw(**{k: jnp.asarray(v) for k, v in draw.items()}),
        jnp.asarray(selected), jnp.asarray(distribute), jnp.asarray(resume),
        jnp.asarray(base), jnp.asarray(every))
    want = jax.tree.map(np.asarray, jax.device_get(want))

    fleet = Fleet(SimConfig(**SIM_TR))
    got = make_trainer(SimConfig(**SIM_TR),
                       federated_classification(N_TR, **DATA_TR),
                       device="cpu", dynamics_features=fleet.features("cpu"))(
        params_from_jax(template),
        C.ClientCaches(params_from_jax(cached), torch.tensor(progress),
                       torch.tensor(stamp)),
        F.FleetDraw(**_t(draw)), torch.tensor(selected),
        torch.tensor(distribute), torch.tensor(resume), torch.tensor(base),
        torch.tensor(every))
    (final, cache_p, cached_steps, loss, steps, fail, success, times) = got
    (w_final, w_cache, w_cached, w_loss, w_steps, w_fail, w_success,
     w_times) = want
    for name, g, w in (("steps_needed", steps, w_steps), ("fail", fail,
                                                          w_fail),
                       ("success", success, w_success),
                       ("cached_steps", cached_steps, w_cached)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert steps.dtype == torch.int32
    np.testing.assert_array_equal(np.isinf(times.numpy()), np.isinf(w_times))
    np.testing.assert_allclose(times.numpy(), w_times, rtol=1e-6)
    for ours, theirs in ((final, w_final), (cache_p, w_cache)):
        for layer in theirs:
            for name in theirs[layer]:
                np.testing.assert_allclose(ours[layer][name].numpy(),
                                           theirs[layer][name], atol=1e-5)
    np.testing.assert_allclose(loss.numpy(), w_loss, rtol=1e-5, atol=1e-7)


def test_draw_helpers_match_reference():
    rng = np.random.RandomState(11)
    n = 200
    draw = dict(online=rng.rand(n) < 0.5,
                fail_p=rng.rand(n).astype(np.float32),
                fail_u=rng.rand(n).astype(np.float32),
                stop_u=rng.rand(n).astype(np.float32),
                bandwidth=rng.rand(n).astype(np.float32),
                battery=rng.rand(n).astype(np.float32))
    ours = F.FleetDraw(**_t(draw))
    theirs = RefDraw(**{k: jnp.asarray(v) for k, v in draw.items()})
    steps = rng.randint(0, 9, n).astype(np.int32)
    dist = rng.rand(n) < 0.5
    np.testing.assert_array_equal(ours.fail.numpy(), np.asarray(theirs.fail))
    np.testing.assert_array_equal(
        ours.failure_mask(torch.from_numpy(steps) * 0.125).numpy(),
        np.asarray(theirs.failure_mask(jnp.asarray(steps) / 8)))
    np.testing.assert_array_equal(
        ours.interruption_step(torch.from_numpy(steps)).numpy(),
        np.asarray(theirs.interruption_step(jnp.asarray(steps))))
    np.testing.assert_array_equal(
        ours.download_mask(torch.from_numpy(dist)).numpy(),
        np.asarray(theirs.download_mask(jnp.asarray(dist))))


def test_round_plan_device_checks_structure_only():
    sel = torch.tensor([True, False, True])
    plan = RoundPlan.device(sel, sel, torch.zeros(3, dtype=torch.bool),
                            torch.tensor(5.0))
    assert plan._validated and isinstance(plan.quorum, torch.Tensor)
    bad = [dict(quorum=torch.ones(3)),
           dict(steps_override=torch.ones(3)),
           dict(steps_override=torch.ones(2, dtype=torch.int32)),
           dict(agg_weights=torch.ones(4)),
           dict(resume=torch.zeros(3))]
    for kw in bad:
        args = dict(selected=sel, distribute=sel,
                    resume=torch.zeros(3, dtype=torch.bool),
                    quorum=torch.tensor(1.0))
        args.update(kw)
        with pytest.raises(ValueError):
            RoundPlan.device(**args)


def test_flconfig_validates_dynamics_against_the_registry():
    for name in F.available_dynamics():
        assert FLConfig(num_clients=8, dynamics=name).dynamics == name
    with pytest.raises(ValueError, match="dynamics"):
        dataclasses.replace(FLConfig(num_clients=8), dynamics="nope")
