"""The port's compact cohorts (``FLConfig.cohort_size``) against the JAX
reference's, on the CPU.

* config validation, with the reference's messages;
* ``cohort_index`` / ``cohort_overflow``, ``FleetDraw.take`` and the
  gather / scatter / expiry cache ops against ``repro``'s on seeded
  random inputs (exact);
* both cohort server steps against the reference's on the same inputs
  (integers exact, floats within 1e-6 of max(1, |x|));
* compact runs of every policy against live JAX compact runs from the
  reference's random numbers (``torch_dynamics_ref``): ``selected``,
  ``received`` and ``comm_mb`` exact, wall clock within 1e-5, accuracy
  within 4/2048; compact against full in the port, padded cohorts, other
  processes, pipeline depths;
* the selection-bound refusal, the runtime overflow and the memory
  profile's packed buffer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.configs.base import FLConfig as RefFLConfig
from repro.data.synthetic import federated_classification as ref_data
from repro.fl import FleetEngine as RefEngine
from repro.fl import classifier as RefCLF
from repro.fl.api import cohort_index as ref_cohort_index
from repro.fl.api import cohort_overflow as ref_cohort_overflow
from repro.fl.simulator import SimConfig as RefSimConfig
from repro.fleet.api import FleetDraw as RefDraw

import repro_torch.fl.engine as ENG
from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import caching as C
from repro_torch.core import round as R
from repro_torch.data.synthetic import federated_classification
from repro_torch.fl import FleetEngine, SimConfig
from repro_torch.fl.api import RoundPlan, cohort_index, cohort_overflow
from repro_torch.fl.policies import MifaPolicy
from repro_torch.fleet import FleetDraw
from repro_torch.tree import tree_map

from torch_dynamics_ref import reference_explore_uniforms, reference_noise

N, ROUNDS = 32, 3
SIM = dict(num_clients=N, rounds=ROUNDS, local_steps=2, batch_size=8,
           seed=3)
FL = dict(num_clients=N, clients_per_round=8, dynamics="markov")
DATA = dict(seed=4, n_per_client=16)
ACC_TOL = 4 / 2048
POLICIES = ["flude", "random", "oort", "safa", "fedsea", "mifa",
            "asyncfeded"]
UNBOUNDED = ("mifa", "asyncfeded")


def with_spare_row(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in a ``spare_rows`` buffer (the layout the cohort
    scatters write into)."""
    out = C.spare_rows(t.shape[0], t.shape[1:], 0, t.dtype, t.device)
    out.copy_(t)
    return out


def _x(policy):
    """The cohort a policy runs under: 8 for the bounded five, N for the
    select-all two."""
    return N if policy in UNBOUNDED else 8


class Pair:
    """A reference engine and a port engine on the same data, template
    and random numbers."""

    def __init__(self, **change):
        fl = dict(FL, **change)
        sim = dict(SIM)
        self.ref = RefEngine(ref_data(N, **DATA), RefSimConfig(**sim),
                             RefFLConfig(**fl))
        template = jax.device_get(RefCLF.init_classifier(
            jax.random.key(sim["seed"] + 1), dim=32, num_classes=10,
            hidden=128, depth=2))
        self.port = FleetEngine(federated_classification(N, **DATA),
                                SimConfig(**sim), FLConfig(**fl),
                                template=params_from_jax(template),
                                device="cpu")
        self.us = reference_explore_uniforms(sim["seed"], ROUNDS, N)
        self.noise = reference_noise(fl["dynamics"], sim["seed"], ROUNDS, N)

    def run_port(self, policy, **kw):
        return self.port.run(policy, explore_uniforms=lambda r: self.us[r],
                             dynamics_noise=lambda r: self.noise[r],
                             diagnostics=False, **kw)

    def run(self, policy, **kw):
        ref = self.ref.run(policy, diagnostics=False, **kw)
        return ref, self.run_port(policy, **kw)


def _same_trajectory(ref, ours):
    assert ours.selected == ref.selected
    assert ours.received == ref.received
    assert ours.eval_mask == ref.eval_mask
    assert ours.comm_mb == ref.comm_mb
    np.testing.assert_allclose(ours.wall_clock, ref.wall_clock, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ours.acc, ref.acc, rtol=0, atol=ACC_TOL)


def _port(fl_change=None, policy="flude", **kw):
    fl = FLConfig(**dict(FL, **(fl_change or {})))
    return FleetEngine(federated_classification(N, **DATA), SimConfig(**SIM),
                       fl, device="cpu").run(policy, diagnostics=False, **kw)


# ---------------------------------------------------------------------------
# Config validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change", [
    dict(cohort_size=0), dict(cohort_size=-3), dict(cohort_size=True),
    dict(cohort_size=2.0), dict(cohort_size=2 * N),
    dict(cohort_size=8, cache_offload="disk"),
    dict(cache_offload="host"), dict(cache_offload="discard"),
    dict(cohort_size=8, cache_offload="discard", cache_staleness_bound=0)],
    ids=["zero", "negative", "bool", "float", "past-fleet", "bad-mode",
         "host-without-cohort", "discard-without-cohort", "bound-0"])
def test_config_refuses_what_the_reference_refuses(change):
    with pytest.raises(ValueError) as theirs:
        RefFLConfig(num_clients=N, **change)
    with pytest.raises(ValueError) as ours:
        FLConfig(num_clients=N, **change)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("change", [
    dict(cohort_size=8), dict(cohort_size=N, dynamics="sessions"),
    dict(cohort_size=8, cache_offload="host"),
    dict(cohort_size=8, cache_offload="discard", cache_staleness_bound=2)])
def test_config_accepts_cohorts_and_offload(change):
    FLConfig(num_clients=N, **change)


def test_cohort_refuses_the_host_side_process():
    with pytest.raises(ValueError, match="bernoulli_host"):
        FleetEngine(federated_classification(N, **DATA), SimConfig(**SIM),
                    FLConfig(num_clients=N, cohort_size=8), device="cpu")


# ---------------------------------------------------------------------------
# cohort_index / cohort_overflow / FleetDraw.take / cache ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_cohort_index_and_overflow_match_reference(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 40))
    sel = rng.rand(n) < rng.rand()
    for x in sorted({1, max(1, int(sel.sum()) - 1), int(sel.sum()) or 1,
                     n}):
        got = cohort_index(torch.from_numpy(sel), x)
        want = np.asarray(ref_cohort_index(sel, x))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        assert bool(cohort_overflow(torch.from_numpy(sel), x)) == \
            bool(ref_cohort_overflow(sel, x))
        plan = RoundPlan(selected=torch.from_numpy(sel),
                         distribute=torch.from_numpy(sel),
                         resume=torch.zeros(n, dtype=torch.bool), quorum=1)
        np.testing.assert_array_equal(plan.cohort_index(x).numpy(), want)


def test_cohort_index_pads_with_the_sentinel_and_truncates():
    sel = torch.zeros(N, dtype=torch.bool)
    sel[[3, 17, 5]] = True
    assert cohort_index(sel, 6).tolist() == [3, 5, 17, N, N, N]
    assert cohort_index(sel, 2).tolist() == [3, 5]
    assert not bool(cohort_overflow(sel, 3))
    assert bool(cohort_overflow(sel, 2))


def _cohort(rng, n):
    x = int(rng.randint(2, n + 1))
    sel = rng.rand(n) < rng.rand()
    while sel.sum() > x:
        sel[np.flatnonzero(sel)[-1]] = False
    return x, sel, np.asarray(ref_cohort_index(sel, x))


@pytest.mark.parametrize("seed", range(4))
def test_draw_take_matches_reference(seed):
    rng = np.random.RandomState(seed)
    n = 24
    _, _, idx = _cohort(rng, n)
    draw = dict(online=rng.rand(n) < 0.6,
                fail_p=rng.rand(n).astype(np.float32),
                fail_u=rng.rand(n).astype(np.float32),
                stop_u=rng.rand(n).astype(np.float32),
                bandwidth=rng.uniform(1, 30, n).astype(np.float32),
                battery=rng.rand(n).astype(np.float32))
    want = RefDraw(**{k: jnp.asarray(v) for k, v in draw.items()}).take(
        jnp.asarray(idx))
    got = FleetDraw(**{k: torch.from_numpy(v) for k, v in draw.items()}
                    ).take(torch.tensor(idx).long())
    for name in draw:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def _rand_caches(rng, n):
    return (dict(w=rng.randn(n, 3, 2).astype(np.float32),
                 b=rng.randn(n, 4).astype(np.float32)),
            rng.rand(n).astype(np.float32),
            rng.randint(-1, 5, n).astype(np.int32))


def _ref_caches(params, progress, stamp):
    return ref_core.ClientCaches(jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(progress), jnp.asarray(stamp))


def _port_caches(params, progress, stamp):
    """Port caches in spare-row buffers, as the engine allocates them."""
    def spare(a):
        return with_spare_row(torch.from_numpy(np.array(a)))
    return C.ClientCaches(tree_map(spare, params), spare(progress),
                          spare(stamp))


def _same_caches(got, want):
    for k in want.params:
        np.testing.assert_array_equal(got.params[k].numpy(),
                                      np.asarray(want.params[k]), err_msg=k)
    np.testing.assert_array_equal(got.progress.numpy(),
                                  np.asarray(want.progress))
    np.testing.assert_array_equal(got.round_stamp.numpy(),
                                  np.asarray(want.round_stamp))


@pytest.mark.parametrize("seed", range(5))
def test_gather_scatter_expire_match_reference(seed):
    rng = np.random.RandomState(seed)
    n = 24
    x, sel, idx = _cohort(rng, n)
    cached = _rand_caches(rng, n)
    idx_t = torch.tensor(idx).long()

    _same_caches(C.gather_caches(_port_caches(*cached), idx_t),
                 ref_core.gather_caches(_ref_caches(*cached), idx))

    mask = (rng.rand(x) < 0.6) & (idx < n)
    block = dict(w=rng.randn(x, 3, 2).astype(np.float32),
                 b=rng.randn(x, 4).astype(np.float32))
    progress = rng.rand(x).astype(np.float32)
    stamps = rng.randint(0, 9, x).astype(np.int32)
    want = ref_core.scatter_write_cache(
        _ref_caches(*cached), jnp.asarray(idx), jnp.asarray(mask),
        jax.tree.map(jnp.asarray, block), jnp.asarray(progress),
        jnp.asarray(stamps))
    got = C.scatter_write_cache(
        _port_caches(*cached), idx_t, torch.from_numpy(mask),
        {k: torch.from_numpy(v) for k, v in block.items()},
        torch.from_numpy(progress), torch.from_numpy(stamps))
    _same_caches(got, want)

    clear = (rng.rand(x) < 0.5) & (idx < n)
    _same_caches(
        C.scatter_clear_cache(_port_caches(*cached), idx_t,
                              torch.from_numpy(clear)),
        ref_core.scatter_clear_cache(_ref_caches(*cached), jnp.asarray(idx),
                                     jnp.asarray(clear)))

    rnd, bound = int(rng.randint(3, 8)), int(rng.randint(1, 4))
    _same_caches(C.expire_caches(_port_caches(*cached), rnd, bound),
                 ref_core.expire_caches(_ref_caches(*cached), rnd, bound))


def test_scatter_refuses_a_buffer_without_its_spare_row():
    caches = C.ClientCaches({}, torch.zeros(4),
                            torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="spare row"):
        C.scatter_clear_cache(caches, torch.tensor([0, 4]),
                              torch.tensor([True, False]))


# ---------------------------------------------------------------------------
# The two cohort server steps
# ---------------------------------------------------------------------------

STEP_CASES = [("mean", None, True), ("mean", None, False),
              ("trust", None, True), ("geometric_median", 4.0, True)]


@pytest.mark.parametrize("offload", [False, True], ids=["resident",
                                                        "offload"])
@pytest.mark.parametrize("rule,adv,uses_cache", STEP_CASES,
                         ids=["mean", "mean-nocache", "trust",
                              "geomed-poison"])
def test_cohort_server_step_matches_reference(rule, adv, uses_cache,
                                              offload):
    """Three rounds from one start, each step fed its own previous
    output: the (N,) metadata, the rule state, the write mask and stamps
    exact; the global model and the cache params within 1e-6 of
    max(1, |x|)."""
    rng = np.random.RandomState(7)
    n, x, steps = 20, 8, 4
    template = jax.tree.map(np.asarray, jax.device_get(
        RefCLF.init_classifier(jax.random.key(1), dim=6, num_classes=3,
                               hidden=8, depth=2)))
    params = jax.tree.map(lambda a: rng.randn(n, *a.shape)
                          .astype(np.float32), template)
    progress = (rng.randint(0, steps + 1, n) / steps).astype(np.float32)
    stamp = rng.randint(-1, 2, n).astype(np.int32)
    mode = "host" if offload else None
    kw = dict(local_steps=steps, agg_rule=rule, adversary_scale=adv,
              uses_cache=uses_cache, cohort_size=x, cache_offload=mode)
    ref_step = ref_core.make_server_round_step(template, agg_impl="xla",
                                               **kw)
    step = R.make_server_round_step(params_from_jax(template),
                                    agg_impl="torch", **kw)
    g_ref, g = jax.tree.map(jnp.asarray, template), \
        params_from_jax(template)
    if offload:
        c_ref = _ref_caches({}, progress, stamp)
        c = _port_caches({}, progress, stamp)
    else:
        c_ref, c = _ref_caches(params, progress, stamp), \
            _port_caches(params, progress, stamp)
    extra_ref, extra = (), ()
    if adv is not None:
        mal = rng.rand(n) < 0.3
        extra_ref, extra = (jnp.asarray(mal),), (torch.from_numpy(mal),)
    if rule == "trust":
        state = np.full(n, 1.0, np.float32)
        extra_ref += (jnp.asarray(state),)
        extra += (with_spare_row(torch.from_numpy(state)),)
    n_samples = np.full(n, 16.0, np.float32)
    for rnd in range(2, 5):
        sel = rng.rand(n) < 0.4
        while sel.sum() > x:
            sel[np.flatnonzero(sel)[0]] = False
        idx = np.asarray(ref_cohort_index(sel, x))
        real = idx < n
        final = jax.tree.map(lambda a: rng.randn(x, *a.shape)
                             .astype(np.float32), template)
        cache_p = jax.tree.map(lambda a: a * 0.5, final)
        cached_steps = np.where(real, rng.randint(0, steps + 1, x),
                                0).astype(np.int32)
        fail = real & (rng.rand(x) < 0.4)
        received = real & ~fail & (rng.rand(x) < 0.8)
        resume = sel & (rng.rand(n) < 0.5)
        extra_w = rng.choice([0.5, 1.0, 2.0], n).astype(np.float32)
        head_ref = (g_ref, c_ref, jax.tree.map(jnp.asarray, final))
        head = (g, c, params_from_jax(final))
        if not offload:
            head_ref += (jax.tree.map(jnp.asarray, cache_p),)
            head += (params_from_jax(cache_p),)
        tail = (cached_steps, idx, sel, fail, received, resume, n_samples,
                extra_w)
        out_ref = ref_step(*head_ref, *map(jnp.asarray, tail), rnd,
                           *extra_ref)
        out = step(*head, *(torch.tensor(np.asarray(a)) for a in tail),
                   rnd, *extra)
        out_ref = jax.tree.map(np.asarray, jax.device_get(out_ref))
        assert len(out) == len(out_ref)
        g, c = out[:2]
        g_ref, c_ref = jax.tree.map(jnp.asarray, out_ref[:2])
        for layer in out_ref[0]:
            for name in out_ref[0][layer]:
                want = out_ref[0][layer][name]
                np.testing.assert_allclose(
                    g[layer][name].numpy(), want, rtol=0,
                    atol=1e-6 * max(1.0, float(np.abs(want).max())))
        for layer in out_ref[1].params:
            for name in out_ref[1].params[layer]:
                np.testing.assert_array_equal(
                    c.params[layer][name].numpy(),
                    out_ref[1].params[layer][name])
        np.testing.assert_array_equal(c.progress.numpy(),
                                      out_ref[1].progress)
        np.testing.assert_array_equal(c.round_stamp.numpy(),
                                      out_ref[1].round_stamp)
        if offload:
            np.testing.assert_array_equal(out[2].numpy(), out_ref[2])
            np.testing.assert_array_equal(out[3].numpy(), out_ref[3])
        if rule == "trust":
            np.testing.assert_allclose(out[-1].numpy(), out_ref[-1],
                                       rtol=0, atol=1e-6)
            extra_ref = extra_ref[:-1] + (jnp.asarray(out_ref[-1]),)
            extra = extra[:-1] + (out[-1],)


def test_cohort_round_cut_matches_the_full_cut():
    """The cut over the (X,) block equals the full cut over all N, and
    the scattered receive mask equals the full one."""
    rng = np.random.RandomState(3)
    n, x = 30, 10
    for _ in range(20):
        sel = rng.rand(n) < 0.3
        while sel.sum() > x:
            sel[np.flatnonzero(sel)[0]] = False
        success = sel & (rng.rand(n) < 0.7)
        times = np.where(success, rng.rand(n) * 900, np.inf) \
            .astype(np.float32)
        quorum = float(rng.randint(0, int(sel.sum()) + 1))
        idx = cohort_index(torch.from_numpy(sel), x)
        online = torch.from_numpy(rng.rand(n) < 0.7)
        dist = torch.from_numpy(sel & (rng.rand(n) < 0.5))
        for waits in (True, False):
            full = R.make_round_cut(n, 600.0, waits)(
                torch.from_numpy(times), quorum, torch.from_numpy(success),
                online, dist, torch.from_numpy(sel))
            cut = R.make_round_cut(x, 600.0, waits, scatter_num_clients=n)(
                C.take_rows(torch.from_numpy(times), idx, float("inf")),
                quorum, C.take_rows(torch.from_numpy(success), idx, False),
                idx, online, dist, torch.from_numpy(sel))
            assert float(cut[0]) == float(full[0])
            assert torch.equal(cut[2], full[1])
            assert bool(cut[3]) == bool(full[2])
            assert [int(v) for v in cut[4:]] == [int(v) for v in full[3:]]


# ---------------------------------------------------------------------------
# Compact runs against the reference's, and against the full scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_compact_run_matches_reference(policy):
    ref, ours = Pair(cohort_size=_x(policy)).run(policy)
    _same_trajectory(ref, ours)


@pytest.mark.parametrize("policy", POLICIES)
def test_compact_matches_full_scan_in_the_port(policy):
    """Compact against full on the port's plain CPU path: the integer
    trajectory and comm exact, wall clock within 1e-5, accuracy within
    4/2048 (fed_agg's plain version sums X rows in place of N, and the
    weight total of X terms in another order)."""
    full = _port(policy=policy)
    compact = _port(dict(cohort_size=_x(policy)), policy=policy)
    _same_trajectory(full, compact)


@pytest.mark.parametrize("x", [12, N])
def test_padded_cohort_matches_reference(x):
    """X above any selection: sentinel rows ride through training, cut,
    aggregation and the scatters."""
    ref, ours = Pair(cohort_size=x).run("flude")
    _same_trajectory(ref, ours)
    _same_trajectory(Pair().run_port("flude"), ours)


@pytest.mark.parametrize("dynamics", ["bernoulli", "sessions"])
def test_compact_matches_reference_under_other_processes(dynamics):
    ref, ours = Pair(cohort_size=8, dynamics=dynamics).run("flude")
    _same_trajectory(ref, ours)


@pytest.mark.parametrize("policy", ["flude", "safa"])
def test_compact_rows_equal_at_depths_1_and_4(policy):
    rows = [_port(dict(cohort_size=8, pipeline_depth=d),
                  policy=policy).to_json() for d in (1, 4)]
    assert rows[0] == rows[1]


def test_compact_adds_no_per_round_uploads(monkeypatch):
    """The cohort index is derived on the device, once a round, at the
    static cohort size: placements stay per engine or per run, as on the
    full scan."""
    counts = {"n": 0}
    orig = ENG.place_per_client
    idx_shapes = []
    orig_index = ENG.cohort_index

    def counting(arr, device):
        counts["n"] += 1
        return orig(arr, device)

    def index(selected, x):
        idx = orig_index(selected, x)
        idx_shapes.append(tuple(idx.shape))
        return idx
    monkeypatch.setattr(ENG, "place_per_client", counting)
    monkeypatch.setattr(ENG, "cohort_index", index)
    engine = FleetEngine(federated_classification(N, **DATA),
                         SimConfig(**SIM),
                         FLConfig(**FL, cohort_size=8, agg_rule="trust"),
                         device="cpu")
    engine.run("flude", diagnostics=False)
    per_run = []
    for rounds in (1, 3):
        counts["n"] = 0
        engine.run("flude", rounds=rounds, diagnostics=False)
        per_run.append(counts["n"])
    assert per_run[0] == per_run[1], per_run
    assert idx_shapes == [(8,)] * (ROUNDS + 1 + 3), idx_shapes


# ---------------------------------------------------------------------------
# Refusals, overflow, memory profile
# ---------------------------------------------------------------------------

def test_selection_bound_above_the_cohort_is_refused_naming_the_policy():
    with pytest.raises(ValueError, match=r"'mifa'.*32"):
        _port(dict(cohort_size=8), policy="mifa")


class _LyingMifa(MifaPolicy):
    """Claims the bounded trait while selecting every online client, so
    only the runtime overflow flag can catch the truncation."""
    selects_at_most_clients_per_round = True


@pytest.mark.parametrize("depth", [1, 2])
def test_runtime_overflow_raises(depth):
    fl = FLConfig(**FL, cohort_size=8, pipeline_depth=depth)
    engine = FleetEngine(federated_classification(N, **DATA),
                         SimConfig(**SIM), fl, device="cpu")
    with pytest.raises(RuntimeError, match="cohort overflow.*'mifa'"):
        engine.run(_LyingMifa(SimConfig(**SIM), fl, device="cpu"),
                   diagnostics=False)


def test_server_step_memory_reports_the_packed_cohort_buffer():
    data = federated_classification(N, **DATA)
    full = FleetEngine(data, SimConfig(**SIM), FLConfig(**FL), device="cpu")
    compact = FleetEngine(data, SimConfig(**SIM),
                          FLConfig(**FL, cohort_size=8), device="cpu")
    dim = sum(int(t.numel()) for t in ENG.tree_leaves(full._template))
    mf, mc = full.server_step_memory(), compact.server_step_memory()
    assert (mf["packed_rows"], mf["packed_buffer_bytes"]) == \
        (N, N * dim * 4)
    assert (mc["packed_rows"], mc["packed_buffer_bytes"]) == (8, 8 * dim * 4)
    assert mc["peak_live_bytes"] < mf["peak_live_bytes"]
    assert mf["cache_device_bytes"] == mc["cache_device_bytes"] \
        == N * 8 + N * dim * 4
    assert mf["cache_host_bytes"] == mc["cache_host_bytes"] == 0


def test_cohort_with_a_dict_caches_leaves_views_of_spare_rows():
    """The engine's caches are (N, ...) views with a spare row behind
    them, written in place round after round (no O(N·D) allocation)."""
    engine = FleetEngine(federated_classification(N, **DATA),
                         SimConfig(**SIM), FLConfig(**FL, cohort_size=8),
                         device="cpu")
    engine.run("flude", diagnostics=False)
    first = engine._last_caches
    ptrs = [t.data_ptr() for t in ENG.tree_leaves(first.params)]
    engine.run("flude", diagnostics=False)
    again = engine._last_caches
    assert [t.data_ptr() for t in ENG.tree_leaves(again.params)] == ptrs
    assert again.progress.shape == (N,)
