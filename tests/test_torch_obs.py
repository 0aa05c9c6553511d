"""Telemetry of the port (``repro_torch.obs``) against the JAX reference
(``repro.obs``), on the CPU.

The metric registry's built-ins on one seeded synthetic round context
must give JAX's values: integers exactly, floats within 1e-5 relative,
except ``agg_residual_*``, within 1e-4 of max(1, ``update_norm_max``) —
the reference expands ||d - m||² = ||d||² - 2⟨d, m⟩ + ||m||² in fp32,
the port computes the distance directly through ``residual_norms`` and
``fed_agg``.  The same bounds hold ``History.metrics`` of a run to JAX's
on the same handed-in noise.  Then the invariants: ``telemetry="full"``
leaves History rows bit-identical for all seven policies at depths 1 and
2 and on the host loop, adds no ``host_readback``, and with telemetry off
nothing is built.  The tracer, sinks, Chrome trace and report CLI mirror
``tests/test_obs.py``.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as RefFLConfig
from repro.data.synthetic import federated_classification as ref_data
from repro.fl import FleetEngine as RefEngine
from repro.fl import classifier as RefCLF
from repro.fl.simulator import SimConfig as RefSimConfig
from repro.obs import metrics as RefOM

import repro_torch.fl.engine as ENG
from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import federated_classification
from repro_torch.fl import FleetEngine, History, SimConfig, make_policy
from repro_torch.obs import metrics as OM
from repro_torch.obs import report as OR
from repro_torch.obs.trace import NullTracer, Tracer

from torch_dynamics_ref import reference_explore_uniforms, reference_noise

ALL_POLICIES = ("flude", "random", "oort", "safa", "fedsea",
                "asyncfeded", "mifa")
# the bounds, stated before the first run: floats 1e-5 relative;
# agg_residual_* 1e-4 of max(1, update_norm_max)
FLOAT_RTOL = 1e-5
RESID_TOL = 1e-4
INT_COLUMNS = ("selected_count", "received_count", "interrupted_count",
               "online_count", "download_count", "cache_rows",
               "cache_hit_count", "cache_expired_count", "staleness_hist")


def _setup(n=16, rounds=3, **fl_kw):
    data = federated_classification(n, seed=0, n_per_client=32)
    sim = SimConfig(num_clients=n, rounds=rounds, seed=0, local_steps=2)
    fl = FLConfig(num_clients=n, clients_per_round=8, **fl_kw)
    return data, sim, fl


def _rows(h):
    return (h.acc, h.wall_clock, h.comm_mb, h.received, h.selected,
            h.eval_mask)


def assert_column_close(name, got, want, norm_max):
    """One metric column (a value or a list over rounds / a vector) held
    to the reference under the bounds above."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if name in INT_COLUMNS:
        np.testing.assert_array_equal(got, want, err_msg=name)
    elif name.startswith("agg_residual"):
        tol = RESID_TOL * np.maximum(1.0, np.asarray(norm_max))
        assert np.all(np.abs(got - want) <= tol), (name, got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Tracer / Chrome export
# ---------------------------------------------------------------------------

def test_tracer_spans_and_summary():
    tr = Tracer()
    with tr.span("a", round=0):
        pass
    with tr.span("a"):
        pass
    with tr.span("b") as sp:
        pass
    assert sp.seconds >= 0.0
    s = tr.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert s["a"]["total_s"] >= s["a"]["max_s"] >= 0.0
    assert s["a"]["mean_s"] == pytest.approx(s["a"]["total_s"] / 2)


def test_tracer_chrome_export(tmp_path):
    tr = Tracer()
    with tr.span("trainer", round=1):
        pass
    with tr.span("observe"):
        pass
    path = str(tmp_path / "trace.json")
    tr.save(path)
    doc = json.load(open(path))
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert evs[0]["ph"] == "M"
    by_name = {e["name"]: e for e in evs}
    x = by_name["trainer"]
    assert x["ph"] == "X" and x["dur"] >= 0 and x["args"] == {"round": 1}
    assert {"pid", "tid", "ts"} <= set(x)
    y = by_name["observe"]
    assert y["ph"] == "X" and "args" not in y and y["ts"] >= x["ts"]


def test_tracer_spans_are_profiler_ranges():
    """Each span opens a torch.profiler range of its name, so a profiler
    window shows it on the timeline."""
    tr = Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("server_step", round=0):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "server_step" in names
    assert tr.summary()["server_step"]["count"] == 1


def test_null_tracer_is_inert():
    nt = NullTracer()
    with nt.span("x", round=9) as sp:
        pass
    assert sp.seconds == 0.0
    assert nt.summary() == {} and nt.events == []
    assert obs.NULL_TRACER.span("a") is obs.NULL_TRACER.span("b")


def test_tracer_reset_clears_events():
    tr = Tracer()
    with tr.span("a"):
        pass
    tr.reset()
    assert tr.events == [] and tr.summary() == {}


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------

def test_jsonl_sink_appends_valid_lines(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    s = obs.JsonlSink(path)
    s.emit({"kind": "round", "x": 1.5, "v": [1, 2]})
    s.emit({"kind": "round", "f": np.float32(2.0)})   # default=float
    s.close()
    s2 = obs.JsonlSink(path)                          # appends
    s2.emit({"kind": "run_end"})
    s2.close()
    lines = [json.loads(l) for l in open(path)]
    assert [l["kind"] for l in lines] == ["round", "round", "run_end"]
    assert lines[1]["f"] == 2.0


def test_tee_sink_fans_out_and_drops_none():
    a, b = obs.MemorySink(), obs.MemorySink()
    t = obs.TeeSink(a, None, b)
    t.emit({"kind": "x"})
    assert a.events == b.events == [{"kind": "x"}]
    t.close()


# ---------------------------------------------------------------------------
# Metric registry
# ---------------------------------------------------------------------------

def test_registry_matches_the_reference():
    assert OM.LEVELS == RefOM.LEVELS
    assert OM.STALENESS_EDGES == RefOM.STALENESS_EDGES
    ours = {n: (s.level, s.needs) for n, s in OM._REGISTRY.items()}
    ref = {n: (s.level, s.needs) for n, s in RefOM._REGISTRY.items()}
    assert ours == ref


def test_registry_levels_and_needs():
    specs = {s.name: s for s in OM.metrics_for(
        "full", {"selected", "received", "fail", "online", "distribute",
                 "losses", "times", "stamp", "resume", "rnd"})}
    assert "counts" in specs and "staleness_hist" in specs
    assert "update_norm" not in specs
    basic = {s.name for s in OM.metrics_for(
        "basic", {"selected", "received", "fail", "online", "distribute",
                  "stamp", "rnd"})}
    assert "staleness_hist" not in basic and "counts" in basic
    with pytest.raises(ValueError, match="telemetry level"):
        OM.metrics_for("verbose", set())


def test_register_metric_validation():
    with pytest.raises(ValueError, match="metric level"):
        OM.register_metric("_t_bad", level="loud")(lambda c, s: {})
    OM.register_metric("_t_dup", needs=())(lambda c, s: {"_t_dup": 0})
    try:
        with pytest.raises(ValueError, match="already registered"):
            OM.register_metric("_t_dup")(lambda c, s: {})
        OM.register_metric("_t_dup", allow_override=True)(
            lambda c, s: {"_t_dup": 1})
        assert "_t_dup" in OM.available_metrics()
    finally:
        OM._REGISTRY.pop("_t_dup", None)


def test_make_metrics_fn_empty_and_needed_keys():
    fn, needed = OM.make_metrics_fn("basic", set(), {})
    assert fn is None and needed == ()
    fn, needed = OM.make_metrics_fn(
        "basic", {"selected", "received", "fail", "online", "distribute"},
        {"num_clients": 8})
    assert fn is not None and "selected" in needed
    assert "num_clients" not in needed


# ---------------------------------------------------------------------------
# Each built-in against JAX's on a seeded synthetic round
# ---------------------------------------------------------------------------

def _synth_ctx():
    rng = np.random.default_rng(7)
    n = 12
    sel = np.zeros(n, bool)
    sel[:8] = True
    online = rng.random(n) < 0.8
    dist = sel.copy()
    recv = sel & online & (rng.random(n) < 0.7)
    fail = sel & ~recv
    resume = np.zeros(n, bool)
    resume[2:5] = True
    losses = rng.random(n).astype(np.float32) * 2
    times = np.where(recv, rng.random(n) * 50, np.inf).astype(np.float32)
    stamp = rng.integers(-1, 6, n).astype(np.int32)
    stamp_pre = stamp.copy()
    stamp[stamp == 1] = -1                   # "expired" rows
    rule_state = rng.random(n).astype(np.float32)
    rows = {"w": rng.standard_normal((n, 3, 2)).astype(np.float32),
            "b": rng.standard_normal((n, 4)).astype(np.float32)}
    glob = {"w": rng.standard_normal((3, 2)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}
    return dict(selected=sel, distribute=dist, resume=resume,
                online=online, received=recv, fail=fail, losses=losses,
                times=times, progress=np.zeros(n, np.float32), stamp=stamp,
                stamp_pre_expire=stamp_pre, rule_state=rule_state,
                rows=rows, rows_mask=recv, rnd=7, **{"global": glob})


def _torch_ctx(ctx):
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, np.ndarray):
            return torch.from_numpy(v.copy())
        return v
    return {k: conv(v) for k, v in ctx.items()}


def _static(**extra):
    return dict({"num_clients": 12, "cohort_size": 8, "local_steps": 2,
                 "staleness_edges": OM.STALENESS_EDGES}, **extra)


def _eval_both(ctx, static):
    avail = set(ctx) | {"cohort_size"}
    rfn, rneed = RefOM.make_metrics_fn("full", avail, static)
    ref = {k: np.asarray(v) for k, v in jax.device_get(
        rfn({k: ctx[k] for k in rneed})).items()}
    fn, need = OM.make_metrics_fn("full", avail, static)
    assert need == rneed
    tctx = _torch_ctx(ctx)
    ours = {k: v.numpy() for k, v in fn({k: tctx[k] for k in need}).items()}
    return ours, ref


@pytest.fixture(scope="module")
def synth_pair():
    return _eval_both(_synth_ctx(), _static())


ALL_COLUMNS = (
    "selected_count", "received_count", "interrupted_count", "online_count",
    "download_count", "local_loss_mean", "local_loss_max",
    "finish_time_mean", "finish_time_max", "cache_rows", "cache_hit_count",
    "cohort_fill", "cache_expired_count", "staleness_hist",
    "trust_quartiles", "trust_min", "trust_max", "update_norm_mean",
    "update_norm_max", "agg_residual_mean", "agg_residual_max")


@pytest.mark.parametrize("column", ALL_COLUMNS)
def test_builtin_matches_reference(synth_pair, column):
    ours, ref = synth_pair
    assert set(ours) == set(ALL_COLUMNS) == set(ref)
    assert_column_close(column, ours[column], ref[column],
                        ref["update_norm_max"])


@pytest.mark.parametrize("bound", [8, 12, 20])
def test_update_norm_rows_bound_gather_matches(bound):
    """With ``rows_bound`` the received rows are gathered into a
    (rows_bound, D) block first; the values must match JAX's gather at a
    tight, an equal and a loose bound."""
    ours, ref = _eval_both(_synth_ctx(), _static(rows_bound=bound))
    for col in ("update_norm_mean", "update_norm_max", "agg_residual_mean",
                "agg_residual_max"):
        assert_column_close(col, ours[col], ref[col],
                            ref["update_norm_max"])


def test_update_norm_runs_the_two_kernels_and_no_receipt_is_zero(
        monkeypatch):
    """update_norm is one fed_agg and two residual_norms calls, at
    (rows_bound, D); a round with no receipt gives zeros, as JAX's."""
    calls = []
    real_fa, real_rn = OM.fed_agg_packed, OM.residual_norms

    def fa(u, w, **kw):
        calls.append(("fed_agg", tuple(u.shape), kw.get("impl")))
        return real_fa(u, w, **kw)

    def rn(u, z, **kw):
        calls.append(("residual_norms", tuple(u.shape), kw.get("impl")))
        return real_rn(u, z, **kw)

    monkeypatch.setattr(OM, "fed_agg_packed", fa)
    monkeypatch.setattr(OM, "residual_norms", rn)
    ctx = _synth_ctx()
    ctx["rows_mask"] = np.zeros(12, bool)
    ours, ref = _eval_both(ctx, _static(rows_bound=8, agg_impl="torch"))
    assert sorted(calls) == [("fed_agg", (8, 10), "torch"),
                             ("residual_norms", (8, 10), "torch"),
                             ("residual_norms", (8, 10), "torch")]
    for col in ("update_norm_mean", "update_norm_max", "agg_residual_mean",
                "agg_residual_max"):
        assert float(ours[col]) == float(ref[col]) == 0.0


# ---------------------------------------------------------------------------
# History.metrics against JAX's on the same handed-in noise
# ---------------------------------------------------------------------------

N, ROUNDS = 24, 5
SIM = dict(num_clients=N, rounds=ROUNDS, seed=3, local_steps=2)
DATA = dict(seed=2, n_per_client=32)


@pytest.mark.parametrize("change", [
    dict(dynamics="bernoulli"),
    dict(dynamics="markov", cohort_size=8, pipeline_depth=2),
    dict(dynamics="bernoulli", agg_rule="trust", adversary="sign_flip",
         adversary_params=(("malicious_frac", 0.2),)),
    dict(dynamics="bernoulli", cohort_size=8, cache_offload="discard",
         cache_staleness_bound=1)],
    ids=["full_scan", "cohort_depth2", "trust", "discard"])
def test_history_metrics_match_reference(change):
    fl = dict(num_clients=N, clients_per_round=8, **change)
    ref = RefEngine(ref_data(N, **DATA), RefSimConfig(**SIM),
                    RefFLConfig(**fl)).run("flude", telemetry="full")
    sim = SimConfig(**SIM)
    template = params_from_jax(jax.device_get(RefCLF.init_classifier(
        jax.random.key(sim.seed + 1), dim=32, num_classes=10,
        hidden=sim.model_hidden, depth=sim.model_depth)))
    us = reference_explore_uniforms(sim.seed, ROUNDS, N)
    noise = reference_noise(change["dynamics"], sim.seed, ROUNDS, N)
    ours = FleetEngine(federated_classification(N, **DATA), sim,
                       FLConfig(**fl), template=template, device="cpu").run(
        "flude", explore_uniforms=lambda r: us[r],
        dynamics_noise=lambda r: noise[r], telemetry="full")
    assert ours.selected == ref.selected and ours.received == ref.received
    assert set(ours.metrics) == set(ref.metrics)
    for name in ref.metrics:
        assert_column_close(name, ours.metrics[name], ref.metrics[name],
                            ref.metrics["update_norm_max"])


def test_host_loop_metrics_match_reference():
    """The golden-style host loop (bernoulli_host) with the reference's
    explore uniforms."""
    fl = dict(num_clients=N, clients_per_round=8)
    ref = RefEngine(ref_data(N, **DATA), RefSimConfig(**SIM),
                    RefFLConfig(**fl)).run("flude", telemetry="full")
    sim = SimConfig(**SIM)
    template = params_from_jax(jax.device_get(RefCLF.init_classifier(
        jax.random.key(sim.seed + 1), dim=32, num_classes=10,
        hidden=sim.model_hidden, depth=sim.model_depth)))
    us = reference_explore_uniforms(sim.seed, ROUNDS, N)
    ours = FleetEngine(federated_classification(N, **DATA), sim,
                       FLConfig(**fl), template=template, device="cpu").run(
        "flude", explore_uniforms=lambda r: us[r], telemetry="full")
    assert ours.selected == ref.selected and ours.received == ref.received
    assert set(ours.metrics) == set(ref.metrics)
    for name in ref.metrics:
        assert_column_close(name, ours.metrics[name], ref.metrics[name],
                            ref.metrics["update_norm_max"])


# ---------------------------------------------------------------------------
# Engine integration: the invariants
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[1, 2], ids=["depth1", "depth2"])
def depth_engine(request):
    data, sim, fl = _setup(dynamics="bernoulli",
                           pipeline_depth=request.param)
    return FleetEngine(data, sim, fl, device="cpu")


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_full_telemetry_is_bit_identical(depth_engine, policy):
    """telemetry="full" must not move the trajectory: History rows are
    bit-identical to a telemetry-off run for every policy at pipeline
    depths 1 and 2."""
    h0 = depth_engine.run(policy, diagnostics=False, telemetry=False)
    h1 = depth_engine.run(policy, diagnostics=False, telemetry="full")
    assert _rows(h1) == _rows(h0), policy
    assert h0.metrics is None
    assert len(h1.metrics["selected_count"]) == len(h1.acc)
    assert h1.metrics["received_count"] == h1.received
    assert h1.metrics["selected_count"] == h1.selected


def test_host_loop_telemetry_bit_identical():
    data, sim, fl = _setup()                 # bernoulli_host loop
    engine = FleetEngine(data, sim, fl, device="cpu")
    h0 = engine.run("flude", diagnostics=False, telemetry=False)
    h1 = engine.run("flude", diagnostics=False, telemetry="full")
    assert _rows(h1) == _rows(h0)
    assert h1.metrics["received_count"] == h1.received
    assert h1.metrics["selected_count"] == h1.selected


@pytest.mark.parametrize("change", [dict(), dict(cohort_size=8),
                                    dict(cohort_size=8,
                                         cache_offload="host")],
                         ids=["full_scan", "cohort", "offload"])
def test_full_telemetry_adds_no_host_readback(monkeypatch, change):
    """The metric values ride the ledger's row: a telemetry="full" run
    goes through ``host_readback`` exactly as often as a telemetry-off
    run (flude, pipelined)."""
    import repro_torch.core.cache_store as CS
    data, sim, fl = _setup(dynamics="bernoulli", pipeline_depth=2,
                           **change)
    engine = FleetEngine(data, sim, fl, device="cpu")
    engine.run("flude", diagnostics=False, telemetry=False)   # warm up
    counts = []
    real = ENG.host_readback

    def counting(device):
        counts.append(1)
        return real(device)

    monkeypatch.setattr(ENG, "host_readback", counting)
    monkeypatch.setattr(CS, "host_readback", counting)
    engine.run("flude", diagnostics=False, telemetry=False)
    off = len(counts)
    counts.clear()
    h = engine.run("flude", diagnostics=False, telemetry="full")
    assert len(counts) == off > 0
    assert h.metrics["selected_count"] == h.selected


def test_telemetry_off_never_builds_metrics(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("make_metrics_fn called with telemetry off")

    monkeypatch.setattr(obs, "make_metrics_fn", boom)
    monkeypatch.setattr(OM, "make_metrics_fn", boom)
    for kw in (dict(dynamics="bernoulli"), dict()):
        data, sim, fl = _setup(**kw)
        engine = FleetEngine(data, sim, fl, device="cpu")
        h = engine.run("flude", diagnostics=False)
        assert h.metrics is None
        assert engine._tracer is obs.NULL_TRACER
        assert engine._metrics_fns == {}


def test_report_losses_match_metrics():
    """local_loss_* and finish_time_* equal numpy reductions of the
    RoundReport the policy observed."""
    data, sim, fl = _setup(dynamics="bernoulli")
    pol = make_policy("flude", sim, fl)
    reports = []
    orig = pol.observe

    def recording(state, plan, report):
        reports.append(tuple(r.numpy().copy() for r in (
            report.received, report.losses, report.durations)))
        return orig(state, plan, report)

    pol.observe = recording
    h = FleetEngine(data, sim, fl, device="cpu").run(
        pol, diagnostics=False, telemetry="full")
    assert len(reports) == len(h.acc)
    for r, (recv, losses, times) in enumerate(reports):
        np.testing.assert_allclose(h.metrics["local_loss_mean"][r],
                                   losses[recv].mean(), rtol=1e-5)
        np.testing.assert_allclose(h.metrics["local_loss_max"][r],
                                   losses[recv].max(), rtol=1e-5)
        np.testing.assert_allclose(h.metrics["finish_time_mean"][r],
                                   times[recv].mean(), rtol=1e-5)


def test_basic_level_and_config_default():
    data, sim, fl = _setup(dynamics="bernoulli", telemetry="basic")
    h = FleetEngine(data, sim, fl, device="cpu").run("flude",
                                                     diagnostics=False)
    assert h.metrics is not None and "selected_count" in h.metrics
    assert "update_norm_mean" not in h.metrics
    assert "staleness_hist" not in h.metrics


def test_flconfig_telemetry_validated():
    with pytest.raises(ValueError, match="telemetry"):
        FLConfig(num_clients=8, telemetry="verbose")
    with pytest.raises(ValueError, match="telemetry level"):
        obs.Telemetry(level="loud")


def test_offload_discard_emits_cache_metrics():
    data, sim, fl = _setup(dynamics="bernoulli", cohort_size=8,
                           cache_offload="discard", cache_staleness_bound=2)
    engine = FleetEngine(data, sim, fl, device="cpu")
    h0 = engine.run("flude", diagnostics=False, telemetry=False)
    h1 = engine.run("flude", diagnostics=False, telemetry="full")
    assert _rows(h1) == _rows(h0)
    assert "cache_expired_count" in h1.metrics
    assert all(0.0 <= f <= 1.0 for f in h1.metrics["cohort_fill"])


def test_history_json_roundtrip():
    data, sim, fl = _setup(dynamics="bernoulli")
    h = FleetEngine(data, sim, fl, device="cpu").run("flude",
                                                     telemetry="full")
    h.trust = np.linspace(0, 1, sim.num_clients)
    d = json.loads(json.dumps(h.to_json()))
    assert "final_params" not in d
    h2 = History.from_json(d)
    assert _rows(h2) == _rows(h)
    assert h2.metrics == h.metrics
    np.testing.assert_allclose(h2.trust, h.trust)


def test_history_from_json_tolerates_golden_dicts():
    h = History.from_json({"acc": [0.5], "wall_clock": [1.0],
                           "comm_mb": [2.0], "received": [3],
                           "selected": [4]})
    assert h.eval_mask == [] and h.metrics is None
    assert h.time_to_accuracy(0.4) == 1.0


def test_profiler_window_shows_the_spans(tmp_path):
    """``profile_rounds`` runs a torch.profiler window whose events hold
    the engine's spans; ``profile_dir`` gets its Chrome trace."""
    data, sim, fl = _setup(dynamics="bernoulli")
    tel = obs.Telemetry(level="basic", profile_rounds=(0, 1),
                        profile_dir=str(tmp_path / "prof"))
    FleetEngine(data, sim, fl, device="cpu").run("flude", diagnostics=False,
                                                 telemetry=tel)
    names = {e.key for e in tel.last_profile.key_averages()}
    assert {"trainer", "round_cut", "server_step", "plan"} <= names
    assert (tmp_path / "prof" / "trace.json").exists()


# ---------------------------------------------------------------------------
# Telemetry session + JSONL + report CLI end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_artifacts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs")
    jsonl = str(tmp / "run.jsonl")
    trace = str(tmp / "trace.json")
    data, sim, fl = _setup(dynamics="bernoulli", cohort_size=8,
                           cache_offload="host")
    tel = obs.Telemetry(level="full", jsonl=jsonl, trace=trace)
    h = FleetEngine(data, sim, fl, device="cpu").run(
        "flude", diagnostics=True, telemetry=tel)
    tel.close()
    return jsonl, trace, tel, h


def test_jsonl_stream_well_formed(run_artifacts):
    jsonl, _, tel, h = run_artifacts
    lines = [json.loads(l) for l in open(jsonl)]
    kinds = [l["kind"] for l in lines]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("round") == len(h.acc)
    start = lines[0]
    assert start["policy"] == "flude" and start["level"] == "full"
    rounds = [l for l in lines if l["kind"] == "round"]
    assert [r["round"] for r in rounds] == list(range(len(h.acc)))
    for r in rounds:
        assert r["received"] == h.received[r["round"]]
        assert r["selected_count"] == h.selected[r["round"]]
    end = lines[-1]
    assert end["rounds"] == len(h.acc)
    assert end["final_acc"] == pytest.approx(h.acc[-1])
    assert end["spans"]["trainer"]["count"] == len(h.acc)
    assert end["transfer_stats"]["sync_copies"] == 0
    assert tel.last_events == lines


def test_trace_file_is_perfetto_loadable(run_artifacts):
    _, trace, tel, h = run_artifacts
    doc = json.load(open(trace))
    evs = doc["traceEvents"]
    assert evs and doc["displayTimeUnit"] == "ms"
    names = {e["name"] for e in evs}
    assert {"rounds", "dynamics_step", "plan", "trainer", "round_cut",
            "metrics", "server_step", "observe", "cache_fetch",
            "cache_stage", "ledger_resolve", "eval", "cache_flush",
            "diagnostics"} <= names
    for e in evs:
        assert "ph" in e and "pid" in e and "tid" in e
        if e["ph"] == "X":
            assert e["dur"] >= 0 and isinstance(e["ts"], float)
    assert tel.tracer.summary()["trainer"]["count"] == len(h.acc)


def test_host_loop_and_discard_spans():
    """The host loop's eval read-back and the discard path's expiry are
    spanned too."""
    data, sim, fl = _setup()
    tel = obs.Telemetry(level="basic")
    FleetEngine(data, sim, fl, device="cpu").run("flude", diagnostics=False,
                                                 telemetry=tel)
    assert {"plan", "trainer", "metrics", "server_step", "observe",
            "eval_readback"} <= set(tel.tracer.summary())
    data, sim, fl = _setup(dynamics="bernoulli", cohort_size=8,
                           cache_offload="discard")
    tel = obs.Telemetry(level="basic")
    FleetEngine(data, sim, fl, device="cpu").run("flude", diagnostics=False,
                                                 telemetry=tel)
    assert tel.tracer.summary()["cache_expire"]["count"] == sim.rounds


def test_report_cli_renders_and_exits_zero(run_artifacts, capsys):
    jsonl, _, _, h = run_artifacts
    assert OR.main([jsonl]) == 0
    out = capsys.readouterr().out
    assert "round-time breakdown" in out
    assert "policy=flude" in out and "local_loss_mean" in out
    assert "cache stream:" in out
    assert OR.main([jsonl, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["rounds"] == len(h.acc)
    assert doc["metrics"]["selected_count"]["last"] == h.selected[-1]
    assert doc["spans"]["trainer"]["count"] == len(h.acc)


def test_report_cli_error_paths(tmp_path, capsys):
    assert OR.main([str(tmp_path / "missing.jsonl")]) == 1
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "round"\n')
    assert OR.main([str(bad)]) == 1
    assert "bad JSON line" in capsys.readouterr().err
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert OR.main([str(empty)]) == 1


def test_report_parse_groups_multiple_runs(tmp_path):
    path = str(tmp_path / "multi.jsonl")
    data, sim, fl = _setup(dynamics="bernoulli", rounds=2)
    engine = FleetEngine(data, sim, fl, device="cpu")
    for policy in ("flude", "random"):
        tel = obs.Telemetry(level="basic", jsonl=path)
        engine.run(policy, diagnostics=False, telemetry=tel)
        tel.close()
    runs = OR.parse_runs(path)
    assert len(runs) == 2
    assert runs[0]["start"]["policy"] == "flude"
    assert runs[1]["start"]["policy"] == "random"
    assert len(runs[1]["rounds"]) == 2 and runs[1]["end"] is not None
    s = OR.summarize(runs[-1])
    assert s["policy"] == "random" and s["rounds"] == 2


def test_sparkline():
    assert OR.sparkline([]) == ""
    assert OR.sparkline([1.0]) == "▁"
    line = OR.sparkline([0, 1, 2, 3])
    assert line[0] == "▁" and line[-1] == "█" and len(line) == 4
    assert len(OR.sparkline(list(range(100)), width=32)) == 32
