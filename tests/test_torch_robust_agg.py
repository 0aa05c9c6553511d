"""The port's robust aggregation and adversaries against the JAX reference.

On the same numpy inputs, on the CPU:

* ``residual_norms`` (plain version, and ``impl="cuda"`` on CPU tensors,
  which takes the plain version) against JAX's ``"xla"`` and
  ``"pallas_interpret"`` residual norms;
* ``geometric_median`` and ``trimmed_mean`` against the float64 oracles at
  the reference's own tolerance, with zero-weight rows and the
  all-zero-weight round; ``masked_median`` and the poison transform
  exactly;
* ``malicious_mask`` and ``corrupt_data`` array for array;
* the full-scan server step under every rule, with and without an
  attack, against the reference's step over three rounds;
* the engine: every robust rule under every attack at N = 12 against the
  reference's ``FleetEngine`` run live in this process, with its initial
  model and explore noise carried over.

The CUDA kernel itself is held to its plain version on the card by
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.configs.base import FLConfig as RefFLConfig
from repro.core.agg_rules import available_agg_rules as ref_rules
from repro.data.synthetic import federated_classification as ref_data
from repro.fl import FleetEngine as RefFleetEngine
from repro.fl import classifier as RefCLF
from repro.fl.simulator import SimConfig as RefSimConfig
from repro.fleet.adversary import available_adversaries as ref_adversaries
from repro.fleet.adversary import make_adversary as ref_make_adversary
from repro.kernels.robust_agg import ops as RefOps

from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import agg_rules as AR
from repro_torch.core import caching as C
from repro_torch.core import round as R
from repro_torch.data.synthetic import federated_classification
from repro_torch.fl import FleetEngine, SimConfig
from repro_torch.fleet import available_adversaries, make_adversary
from repro_torch.kernels.robust_agg import kernel as K
from repro_torch.kernels.robust_agg import ops
from repro_torch.kernels.robust_agg.ref import (geometric_median_ref,
                                                geometric_median_torch,
                                                trimmed_mean_ref)

# the reference's tolerances: tests/test_robust_agg.py
NORM_RTOL = 1e-5
ORACLE_RTOL, ORACLE_ATOL = 2e-4, 2e-5
# accuracy over 2048 test samples: a few flipped predictions from fp32
# summation order in four rounds of local SGD
ACC_TOL = 4 / 2048
TRUST_TOL = 1e-5
N = 12


def _updates(c=7, d=33, seed=0, w_zero=2):
    rng = np.random.RandomState(seed)
    u = rng.randn(c, d).astype(np.float32)
    w = rng.rand(c).astype(np.float32) + 0.1
    w[rng.permutation(c)[:w_zero]] = 0.0
    return u, w


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Kernel wrapper and reductions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C_,D_", [(9, 50), (13, 2049), (1, 7), (40, 1)])
@pytest.mark.parametrize("ref_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_residual_norms_match_reference(C_, D_, ref_impl, impl):
    u, _ = _updates(c=C_, d=D_, seed=C_ * D_, w_zero=0)
    z = u.mean(0) + 0.1
    want = np.asarray(RefOps.residual_norms(
        jnp.asarray(u), jnp.asarray(z), impl=ref_impl, block_c=4,
        block_d=16))
    launches = K.launches.count
    got = ops.residual_norms(_t(u), _t(z), impl=impl)
    assert K.launches.count == launches        # no kernel on the CPU
    assert got.shape == (C_,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=NORM_RTOL, atol=0)


@pytest.mark.parametrize("shape", [(0, 5), (3, 0)])
def test_residual_norms_of_empty_input_are_zeros(shape):
    got = ops.residual_norms(torch.zeros(shape), torch.zeros(shape[1]))
    assert got.shape == (shape[0],) and not got.any()


def test_residual_norms_rejects_unknown_impl():
    u, _ = _updates()
    with pytest.raises(ValueError, match="impl"):
        ops.residual_norms(_t(u), _t(u[0]), impl="xla")


@pytest.mark.parametrize("w_zero", [0, 2, 7])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_geometric_median_matches_oracle_and_reference(w_zero, impl):
    for seed in range(3):
        u, w = _updates(seed=seed, w_zero=w_zero)
        got = ops.geometric_median(_t(u), _t(w), impl=impl).numpy()
        np.testing.assert_allclose(got, geometric_median_ref(u, w),
                                   rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
        np.testing.assert_allclose(
            geometric_median_torch(_t(u), _t(w)).numpy(),
            geometric_median_ref(u, w), rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
        want = np.asarray(RefOps.geometric_median(
            jnp.asarray(u), jnp.asarray(w), impl="pallas_interpret",
            block_c=4, block_d=16))
        np.testing.assert_allclose(got, want, rtol=ORACLE_RTOL,
                                   atol=ORACLE_ATOL)
        if w_zero == 7:                      # the all-zero-weight round
            assert not got.any()


def test_geometric_median_zero_iterations_is_the_weighted_mean():
    u, w = _updates(seed=4)
    got = ops.geometric_median(_t(u), _t(w), iters=0, impl="torch")
    np.testing.assert_allclose(got.numpy(), (w / w.sum()) @ u, atol=1e-6)


def test_geometric_median_ignores_zero_weight_rows():
    u, w = _updates(c=8, w_zero=0, seed=9)
    w[:3] = 0.0
    u2 = np.array(u)
    u2[:3] = 1e6                             # garbage in the dead rows
    a = ops.geometric_median(_t(u), _t(w), impl="torch")
    b = ops.geometric_median(_t(u2), _t(w), impl="torch")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("w_zero", [0, 2, 7])
@pytest.mark.parametrize("trim", [0.2, 0.3, 0.5])
def test_trimmed_mean_matches_oracle_and_reference(w_zero, trim):
    for seed in range(3):
        u, w = _updates(seed=seed, w_zero=w_zero)
        u[:, :4] = np.round(u[:, :4])         # ties within a column
        got = ops.trimmed_mean(_t(u), _t(w), trim=trim).numpy()
        np.testing.assert_allclose(got, trimmed_mean_ref(u, w, trim=trim),
                                   rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
        want = np.asarray(RefOps.trimmed_mean(jnp.asarray(u),
                                              jnp.asarray(w), trim=trim))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        if w_zero == 7:
            assert not got.any()


def test_masked_median_matches_reference_exactly():
    rng = np.random.RandomState(0)
    for n in (1, 2, 5, 8):
        for _ in range(10):
            x = rng.randn(n).astype(np.float32)
            valid = rng.rand(n) < 0.6
            want = np.asarray(RefOps.masked_median(jnp.asarray(x),
                                                   jnp.asarray(valid)))
            got = ops.masked_median(_t(x), _t(valid))
            assert got.item() == want.item()
    x = np.array([5.0, 1.0, 9.0, 3.0, 7.0], np.float32)
    valid = np.array([True, True, False, True, True])
    assert ops.masked_median(_t(x), _t(valid)).item() == 3.0
    assert ops.masked_median(_t(x), _t(np.zeros(5, bool))).item() == 0.0


# ---------------------------------------------------------------------------
# Rules and the server step
# ---------------------------------------------------------------------------

def test_registries_hold_the_reference_builtins():
    assert set(AR.available_agg_rules()) <= set(ref_rules())
    assert AR.available_agg_rules() == ["geometric_median", "mean",
                                        "trimmed_mean", "trust"]
    assert available_adversaries() == ref_adversaries()
    with pytest.raises(KeyError, match="geometric_median"):
        AR.get_agg_rule("krum")
    with pytest.raises(TypeError, match="AggRule subclass"):
        AR.register_agg_rule("bogus")(dict)
    with pytest.raises(NotImplementedError, match="stateless"):
        AR.MeanRule().init_state(4)


@pytest.mark.parametrize("name,params", [
    ("sign_flip", ()), ("grad_scale", (("scale", 3.0),)),
    ("label_flip", (("malicious_frac", 0.25),))])
def test_adversaries_mark_and_corrupt_like_the_reference(name, params):
    ours, theirs = make_adversary(name, params), \
        ref_make_adversary(name, params)
    assert (ours.delta_scale, ours.flips_labels) == \
        (theirs.delta_scale, theirs.flips_labels)
    for n, seed in ((12, 0), (50, 3), (4096, 8), (7, 2 ** 31 - 1)):
        np.testing.assert_array_equal(ours.malicious_mask(n, seed),
                                      theirs.malicious_mask(n, seed))
    mask = ours.malicious_mask(N, 0)
    a = ours.corrupt_data(federated_classification(N, seed=1,
                                                   n_per_client=8), mask)
    b = theirs.corrupt_data(ref_data(N, seed=1, n_per_client=8), mask)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_trust_rule_runs_norms_median_update_then_fed_agg(monkeypatch):
    calls = []

    def spy(name, fn):
        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(AR, name, run)

    for name in ("residual_norms", "masked_median", "fed_agg_packed"):
        spy(name, getattr(AR, name))
    rule = AR.make_agg_rule("trust")
    monkeypatch.setattr(rule, "_update", lambda *a: (
        calls.append("_update"), AR.TrustRule._update(rule, *a))[1])
    u, w = _updates()
    rule.reduce_stateful(_t(u), _t(u[0]), _t(w), torch.ones(len(w)),
                         impl="torch")
    assert calls == ["residual_norms", "masked_median", "_update",
                     "fed_agg_packed"]


@pytest.mark.parametrize("rule,norms,sums", [
    ("mean", 0, 1), ("geometric_median", 6, 7), ("trimmed_mean", 0, 0),
    ("trust", 1, 1)])
def test_server_step_calls_each_reduction_as_often_as_the_reference(
        monkeypatch, rule, norms, sums):
    """On the card each call is one kernel launch: per round, the mean
    runs one weighted sum and no norms; ``geometric_median`` 7 and 6."""
    from repro_torch.core import aggregation as AGG
    from repro_torch.kernels.robust_agg import ops as OPS
    count = {"norms": 0, "sums": 0}

    def counted(key, fn):
        def run(*a, **kw):
            count[key] += 1
            return fn(*a, **kw)
        return run

    for mod in (AR, OPS):
        monkeypatch.setattr(mod, "residual_norms",
                            counted("norms", OPS.residual_norms))
    for mod in (AR, OPS, AGG):
        monkeypatch.setattr(mod, "fed_agg_packed",
                            counted("sums", AGG.fed_agg_packed))
    template = {"a": {"w": torch.ones(3, 2), "b": torch.zeros(2)}}
    step = R.make_server_round_step(template, local_steps=2,
                                    agg_rule=rule, adversary_scale=-4.0)
    n = 5
    final = {"a": {"w": torch.randn(n, 3, 2), "b": torch.randn(n, 2)}}
    mask = torch.tensor([True, True, False, True, False])
    extra = (mask,) + ((torch.ones(n),) if rule == "trust" else ())
    step(template, C.init_caches(template, n), final, final,
         torch.zeros(n, dtype=torch.int32), mask, ~mask, mask,
         torch.zeros(n, dtype=torch.bool), torch.ones(n), torch.ones(n), 0,
         *extra)
    assert count == {"norms": norms, "sums": sums}


def test_poison_is_the_reference_transform_exactly():
    """One received client, a malicious one: the mean is its poisoned
    upload exactly (weight 1.0, every other term 0), on both sides; the
    cache keeps the honest snapshot."""
    rng = np.random.RandomState(0)
    template = jax.device_get(RefCLF.init_classifier(
        jax.random.key(0), dim=5, num_classes=3, hidden=4, depth=1))
    n = 6
    final = jax.tree.map(
        lambda a: rng.randn(n, *a.shape).astype(np.float32), template)
    malicious = np.array([0, 0, 1, 0, 1, 0], bool)
    received = np.array([0, 0, 1, 0, 0, 0], bool)
    selected = np.ones(n, bool)
    fail = ~received & (np.arange(n) % 2 == 0)
    cached = np.full(n, 2, np.int32)
    zeros = np.zeros(n, bool)
    args = (cached, selected, fail, received, zeros,
            np.ones(n, np.float32), np.ones(n, np.float32))
    ref_step = ref_core.make_server_round_step(
        template, local_steps=2, adversary_scale=-4.0)
    g_ref, c_ref = ref_step(
        template, ref_core.init_caches(template, n), final, final,
        *map(jnp.asarray, args), 1, jnp.asarray(malicious))
    step = R.make_server_round_step(params_from_jax(template),
                                    local_steps=2, adversary_scale=-4.0)
    g, c = step(params_from_jax(template),
                C.init_caches(params_from_jax(template), n),
                params_from_jax(final), params_from_jax(final),
                *map(_t, args), 1, _t(malicious))
    for layer in template:
        for name in template[layer]:
            np.testing.assert_array_equal(g[layer][name].numpy(),
                                          np.asarray(g_ref[layer][name]))
            np.testing.assert_array_equal(
                c.params[layer][name].numpy(),
                np.asarray(c_ref.params[layer][name]))


@pytest.mark.parametrize("adversary_scale", [None, -4.0])
@pytest.mark.parametrize("rule,params", [
    ("mean", ()), ("geometric_median", ()),
    ("trimmed_mean", (("trim", 0.3),)), ("trust", ())])
def test_server_step_matches_reference(rule, params, adversary_scale):
    """Three rounds from one start, each fed its own previous output,
    with failures, resumes, weight multipliers and an empty round."""
    rng = np.random.RandomState(1)
    n, steps = 10, 4
    template = jax.device_get(RefCLF.init_classifier(
        jax.random.key(1), dim=6, num_classes=3, hidden=8, depth=2))
    ref_step = ref_core.make_server_round_step(
        template, local_steps=steps, agg_rule=rule, agg_rule_params=params,
        adversary_scale=adversary_scale, block_c=4, block_d=16)
    step = R.make_server_round_step(
        params_from_jax(template), local_steps=steps, agg_rule=rule,
        agg_rule_params=params, adversary_scale=adversary_scale)
    g_ref = jax.tree.map(jnp.asarray, template)
    c_ref = ref_core.init_caches(g_ref, n)
    g, c = params_from_jax(template), C.init_caches(
        params_from_jax(template), n)
    malicious = rng.rand(n) < 0.3
    trust_ref = trust = None
    if rule == "trust":
        trust_ref = jnp.ones(n, jnp.float32)
        trust = torch.ones(n)
    for rnd in range(3):
        final = jax.tree.map(
            lambda a: (a[None] + 0.1 * rng.randn(n, *a.shape)
                       ).astype(np.float32), template)
        selected = rng.rand(n) < 0.8
        fail = selected & (rng.rand(n) < 0.3)
        received = selected & ~fail
        if rnd == 1:
            received[:] = False                      # empty round
        resume = selected & (rng.rand(n) < 0.5)
        args = (rng.randint(0, steps + 1, n).astype(np.int32), selected,
                fail, received, resume, np.full(n, 32.0, np.float32),
                rng.choice([0.5, 1.0, 2.0], n).astype(np.float32))
        ref_extra = ((jnp.asarray(malicious),) if adversary_scale else ()) \
            + ((trust_ref,) if trust_ref is not None else ())
        extra = ((_t(malicious),) if adversary_scale else ()) \
            + ((trust,) if trust is not None else ())
        out_ref = ref_step(g_ref, c_ref, jax.tree.map(jnp.asarray, final),
                           jax.tree.map(jnp.asarray, final),
                           *map(jnp.asarray, args), rnd, *ref_extra)
        out = step(g, c, params_from_jax(final), params_from_jax(final),
                   *map(_t, args), rnd, *extra)
        g_ref, c_ref, g, c = out_ref[0], out_ref[1], out[0], out[1]
        if trust is not None:
            trust_ref, trust = out_ref[2], out[2]
            np.testing.assert_allclose(trust.numpy(), np.asarray(trust_ref),
                                       atol=TRUST_TOL)
        for layer in template:
            for name in template[layer]:
                np.testing.assert_allclose(
                    g[layer][name].numpy(), np.asarray(g_ref[layer][name]),
                    rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
        np.testing.assert_array_equal(c.round_stamp.numpy(),
                                      np.asarray(c_ref.round_stamp))


def test_server_step_checks_its_trailing_arguments():
    template = {"a": {"w": torch.ones(2)}}
    step = R.make_server_round_step(template, local_steps=1,
                                    agg_rule="trust", adversary_scale=2.0)
    n = 3
    b = torch.ones(n, dtype=torch.bool)
    with pytest.raises(TypeError, match="2 trailing"):
        step(template, C.init_caches(template, n),
             {"a": {"w": torch.ones(n, 2)}}, {"a": {"w": torch.ones(n, 2)}},
             torch.zeros(n, dtype=torch.int32), b, ~b, b, ~b,
             torch.ones(n), torch.ones(n), 0, b)


# ---------------------------------------------------------------------------
# Config and engine
# ---------------------------------------------------------------------------

def test_flconfig_accepts_the_robust_axis_and_rejects_unknown_names():
    FLConfig(num_clients=8, agg_rule="trust", adversary="label_flip",
             agg_rule_params=(("eta", 0.5),),
             adversary_params=(("malicious_frac", 0.25),))
    with pytest.raises(ValueError, match="geometric_median"):
        FLConfig(num_clients=8, agg_rule="median_of_means")
    with pytest.raises(ValueError, match="sign_flip"):
        FLConfig(num_clients=8, adversary="backdoor")


SIM = dict(num_clients=N, rounds=4, seed=0, local_steps=2)
FL = dict(num_clients=N, clients_per_round=6)
DATA = dict(seed=0, n_per_client=24, dim=8, num_classes=4)


def _explore_uniforms(seed, rounds, n):
    """The reference's per-round explore noise (its ``_host_rounds``)."""
    rng, out = jax.random.key(seed), []
    for _ in range(rounds):
        rng, k = jax.random.split(rng)
        out.append(np.asarray(jax.random.uniform(k, (n,))))
    return out


@pytest.fixture(scope="module")
def carried():
    sim = SimConfig(**SIM)
    template = jax.device_get(RefCLF.init_classifier(
        jax.random.key(sim.seed + 1), dim=DATA["dim"],
        num_classes=DATA["num_classes"], hidden=sim.model_hidden,
        depth=sim.model_depth))
    return template, _explore_uniforms(sim.seed, sim.rounds, N)


@pytest.mark.parametrize("adversary", ["sign_flip", "grad_scale",
                                       "label_flip"])
@pytest.mark.parametrize("rule", ["geometric_median", "trimmed_mean",
                                  "trust"])
def test_engine_matches_reference_under_attack(carried, rule, adversary):
    template, us = carried
    robust = dict(agg_rule=rule, adversary=adversary,
                  adversary_params=(("malicious_frac", 0.25),))
    ref = RefFleetEngine(ref_data(N, **DATA), RefSimConfig(**SIM),
                         RefFLConfig(**FL, **robust)).run("flude")
    engine = FleetEngine(federated_classification(N, **DATA),
                         SimConfig(**SIM), FLConfig(**FL, **robust),
                         template=params_from_jax(template), device="cpu")
    port = engine.run("flude", explore_uniforms=lambda rnd: us[rnd])
    assert port.selected == ref.selected
    assert port.received == ref.received
    np.testing.assert_array_equal(port.part_count, ref.part_count)
    np.testing.assert_allclose(port.wall_clock, ref.wall_clock, atol=1e-5)
    np.testing.assert_allclose(port.comm_mb, ref.comm_mb, atol=1e-5)
    np.testing.assert_allclose(port.acc, ref.acc, atol=ACC_TOL)
    if rule == "trust":
        assert port.trust.shape == (N,)
        np.testing.assert_allclose(port.trust, ref.trust, atol=TRUST_TOL)
    else:
        assert port.trust is None and getattr(ref, "trust", None) is None
    again = engine.run("flude", explore_uniforms=lambda rnd: us[rnd])
    assert again.to_json() == port.to_json()      # fresh rule state per run


def test_label_flip_poisons_training_labels_only():
    data = federated_classification(N, **DATA)
    fl = FLConfig(**FL, adversary="label_flip",
                  adversary_params=(("malicious_frac", 0.25),))
    engine = FleetEngine(data, SimConfig(**SIM), fl, device="cpu")
    mask = make_adversary("label_flip", fl.adversary_params) \
        .malicious_mask(N, SIM["seed"])
    np.testing.assert_array_equal(engine.data.y[mask],
                                  DATA["num_classes"] - 1 - data.y[mask])
    np.testing.assert_array_equal(engine.data.y[~mask], data.y[~mask])
    np.testing.assert_array_equal(engine.data.test_y, data.test_y)


def test_mean_rule_through_the_generic_path_is_bit_identical(monkeypatch):
    """The mean forced through the generic rule machinery (pack, reduce,
    gate, unpack) reproduces the direct ``agg_rule="mean"`` History bit
    for bit, as the reference's ``mean_alias`` test shows for JAX."""
    class _MeanAlias(AR.MeanRule):
        name = "mean_alias"

    monkeypatch.setitem(AR._REGISTRY, "mean_alias", _MeanAlias)
    data = federated_classification(N, **DATA)
    hists = [FleetEngine(data, SimConfig(**SIM),
                         FLConfig(**FL, agg_rule=rule, adversary="sign_flip"),
                         device="cpu").run("flude")
             for rule in ("mean", "mean_alias")]
    assert hists[0].to_json() == hists[1].to_json()
    assert hists[0].trust is None
