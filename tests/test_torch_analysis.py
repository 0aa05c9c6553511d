"""The port's analysis package (``repro_torch.analysis``), on the CPU:
the repo lint, the op checks and the invariant auditor, and the
``debug_checks`` sanitisers, mirroring ``tests/test_analysis.py``.

Every checker must fire on a planted violation, naming its place; then
the clean paths: the real round path audits clean (flude, full scan,
cohort and offload), ``src/repro_torch`` lints clean, and a
``debug_checks=True`` run gives the rows of an unchecked one.
"""
import dataclasses
import os
import types

import pytest
import torch

import repro_torch.fl.engine as ENG
from repro_torch.analysis import lint as L
from repro_torch.analysis import op_checks as OC
from repro_torch.analysis import runtime as RT
from repro_torch.analysis.audit import (audit_engine, build_audited,
                                        check_transfer_stats,
                                        main as audit_main,
                                        transfer_ceiling)
from repro_torch.configs.base import FLConfig
from repro_torch.core import caching as C
from repro_torch.core.cache_store import TransferStats
from repro_torch.data.synthetic import federated_classification
from repro_torch.device import host_readback
from repro_torch.fl import FleetEngine, SimConfig
from repro_torch.tree import tree_map

_SRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")


def _rules(findings):
    return sorted({f.rule for f in findings})


def _small_engine(**fl_kw):
    n = 16
    data = federated_classification(n, num_classes=3, dim=8,
                                    n_per_client=12, n_test=24, seed=1)
    sim = SimConfig(num_clients=n, rounds=3, local_steps=2, batch_size=6,
                    model_hidden=8, model_depth=1, seed=0)
    fl_kw.setdefault("dynamics", "markov")
    fl = FLConfig(num_clients=n, clients_per_round=8, **fl_kw)
    return FleetEngine(data, sim, fl, device="cpu")


def _rows(h):
    return (h.acc, h.wall_clock, h.comm_mb, h.received, h.selected,
            h.eval_mask)


# ---------------------------------------------------------------------------
# Repo lint: each rule fires on a planted snippet; the port lints clean
# ---------------------------------------------------------------------------

def test_lint_flags_host_syncs_in_round_path_modules():
    src = ("import numpy as np\n"
           "import torch\n"
           "def hot(x):\n"
           "    a = x.item()\n"
           "    b = x.tolist()\n"
           "    c = x.cpu()\n"
           "    d = x.numpy()\n"
           "    e = np.asarray(x)\n"
           "    f = float(run(x))\n"
           "    g = int(run(x))\n"
           "    h = bool(run(x))\n"
           "    i = torch.nonzero(x)\n"
           "    j = x.masked_select(x > 0)\n"
           "    k = torch.unique(x)\n"
           "    return a, b, c, d, e, f, g, h, i, j, k\n")
    bad = L.lint_source(src, "repro_torch/fl/engine.py")
    assert len(bad) == 11 and _rules(bad) == ["host-sync"]
    assert [f.line for f in bad] == list(range(4, 15))
    for module in ("repro_torch/core/round.py",
                   "repro_torch/core/cache_store.py",
                   "repro_torch/obs/metrics.py"):
        assert len(L.lint_source(src, module)) == 11
    # the same code outside a round-path module is not the lint's business
    assert L.lint_source(src, "repro_torch/obs/report.py") == []
    # allowlisted seams are exempt, nested defs included
    seam = src.replace("def hot", "def host_round_cut")
    assert L.lint_source(seam, "repro_torch/core/round.py") == []


def test_lint_sanctions_the_host_readback_body_only():
    src = ("def resolve(x, dev):\n"
           "    with host_readback(dev):\n"
           "        a = x.tolist()\n"
           "        b = float(x.sum())\n"
           "    return a, b, x.item()\n")
    bad = L.lint_source(src, "repro_torch/fl/engine.py")
    assert [(f.line, f.rule) for f in bad] == [(5, "host-sync")]
    other = src.replace("host_readback", "torch.no_grad")
    assert len(L.lint_source(other, "repro_torch/fl/engine.py")) == 3


def test_lint_flags_mutable_global_but_not_frozen_configs():
    bad = L.lint_source("STATS = TransferStats()\n",
                        "repro_torch/core/cache_store.py")
    assert "mutable-global" in _rules(bad)
    assert L.lint_source("CONFIG = ModelConfig(dim=4)\n",
                         "repro_torch/configs/qwen2_7b.py") == []
    assert L.lint_source("helper = Maker()\nX = compute()\n",
                         "repro_torch/fl/api.py") == []
    assert L.lint_source("NULL_TRACER = NullTracer()\n",
                         "repro_torch/obs/trace.py") == []


@pytest.mark.parametrize("deco", sorted(L._REGISTER_DECORATORS))
def test_lint_flags_undocumented_or_computed_registry_names(deco):
    src = (f"@{deco}(NAME)\n"
           "def my_thing(cfg):\n"
           "    return 1\n")
    bad = L.lint_source(src, "repro_torch/fl/policies.py")
    assert _rules(bad) == ["registry"] and len(bad) == 2
    ok = (f"@{deco}(\"mine\")\n"
          "def my_thing(cfg):\n"
          "    \"\"\"Documented.\"\"\"\n"
          "    return 1\n")
    assert L.lint_source(ok, "repro_torch/fl/policies.py") == []


def test_lint_requires_post_init_registry_validation():
    src = ("class FLConfig:\n"
           "    def __post_init__(self):\n"
           "        pass\n")
    bad = L.lint_source(src, "repro_torch/configs/base.py")
    assert len(bad) == len(L._POST_INIT_VALIDATORS)
    assert _rules(bad) == ["registry"]


@pytest.mark.parametrize("module,fn", [
    ("repro_torch/fl/engine.py", "make_trainer"),
    ("repro_torch/core/round.py", "make_server_round_step"),
    ("repro_torch/core/round.py", "make_round_cut"),
    ("repro_torch/obs/metrics.py", "make_metrics_fn")])
def test_lint_flags_host_clock_or_rng_in_round_functions(module, fn):
    src = ("import time, random\n"
           "import numpy as np\n"
           "import torch\n"
           f"def {fn}(cfg):\n"
           "    def body(x):\n"
           "        torch.manual_seed(0)\n"
           "        return x * time.time() + random.random() \\\n"
           "            + np.random.rand()\n"
           "    return body\n")
    bad = L.lint_source(src, module)
    assert _rules(bad) == ["round-determinism"] and len(bad) == 4
    # outside the round functions a clock read is fine
    ok = src.replace(f"def {fn}", "def host_side")
    assert L.lint_source(ok, module) == []


def test_lint_flags_host_rng_in_a_registered_metric():
    src = ("import time\n"
           "@register_metric(\"t\")\n"
           "def _t(ctx, static):\n"
           "    \"\"\"Documented.\"\"\"\n"
           "    return {\"t\": time.perf_counter()}\n")
    bad = L.lint_source(src, "repro_torch/obs/extra.py")
    assert _rules(bad) == ["round-determinism"]


def test_lint_flags_deprecated_stats_references():
    bad = L.lint_source("from repro_torch.core.cache_store import STATS\n",
                        "repro_torch/fl/engine.py")
    assert "deprecated-stats" in _rules(bad)
    bad = L.lint_source("import repro_torch.core.cache_store as CS\n"
                        "def f():\n"
                        "    CS.STATS.reset()\n",
                        "repro_torch/obs/report.py")
    assert "deprecated-stats" in _rules(bad)


def test_port_lints_clean(capsys):
    """``python -m repro_torch.analysis.lint src/repro_torch`` exits 0."""
    findings = L.lint_paths([_SRC])
    assert findings == [], "\n".join(str(f) for f in findings)
    assert L.main([_SRC]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Op checks: planted violations
# ---------------------------------------------------------------------------

def test_op_checks_flag_a_planted_item():
    x = torch.arange(4.0)
    with OC.OpChecks() as oc:
        y = (x * 2).sum()
        float(y)
    assert [f.contract for f in oc.findings] == ["host-op"]
    assert "_local_scalar_dense" in oc.findings[0].message
    assert "test_op_checks_flag_a_planted_item" in oc.findings[0].where
    with OC.OpChecks() as oc:
        with host_readback("cpu"):
            (x * 2).sum().item()
        torch.nonzero(x)
    assert [f.message.split()[0] for f in oc.findings] == ["aten.nonzero"]


def test_op_checks_flag_a_float64_op_outside_the_ledger_row():
    with OC.OpChecks() as oc:
        torch.ones(3) + 1
        torch.ones(3, dtype=torch.float64) * 2
    assert [f.contract for f in oc.findings] == ["no-f64"] * 2
    assert oc.ops >= 4


def test_op_checks_blocking_device_to_host_copy():
    dev = torch.empty(4, device="meta")
    host = torch.empty(4)
    assert OC._blocking_d2h("copy_", (host, dev), {})
    assert OC._blocking_d2h("copy_", (host, dev, True), {})  # pageable
    assert not OC._blocking_d2h("copy_", (dev, host), {})    # h2d
    assert OC._blocking_d2h("_to_copy", (dev,), {"device": "cpu"})
    assert not OC._blocking_d2h("_to_copy", (host,), {"device": "cpu"})


def test_audit_flags_a_planted_sync_in_the_round():
    engine = _small_engine()
    engine.run("flude", rounds=1, diagnostics=False)

    def syncing(cut):
        def syncing_cut(*args):
            out = cut(*args)
            int(out[1].sum())                   # the planted wait
            return out
        return syncing_cut

    engine._cut_fns = {k: syncing(v) for k, v in engine._cut_fns.items()}
    report = audit_engine(engine, "flude")
    assert not report.ok()
    assert {f.contract for f in report.findings} == {"host-op"}
    assert "syncing_cut" in report.findings[0].where
    with pytest.raises(AssertionError, match=r"\[host-op\] .*syncing_cut"):
        report.raise_on_findings()


def test_audit_flags_a_reallocated_cache():
    """A server step that returns fresh cache storage on the cohort path
    (where the scatters write in place) breaks the in-place contract."""
    engine = _small_engine(cohort_size=8)
    engine.run("flude", rounds=1, diagnostics=False)

    def realloc(step):
        def run(*args):
            out = step(*args)
            def moved(t):         # fresh storage, spare row and all
                fresh = C.spare_rows(t.shape[0], t.shape[1:], 0, t.dtype)
                return fresh.copy_(t)
            caches = C.ClientCaches(tree_map(moved, out[1].params),
                                    moved(out[1].progress),
                                    moved(out[1].round_stamp))
            return (out[0], caches) + tuple(out[2:])
        return run

    engine._server_steps = {k: realloc(v)
                            for k, v in engine._server_steps.items()}
    report = audit_engine(engine, "flude")
    contracts = {f.contract for f in report.findings}
    assert contracts == {"in-place"}, report.summary()
    assert any("caches.progress" in f.message for f in report.findings)


# ---------------------------------------------------------------------------
# The auditor on the real round path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "cohort", "offload"])
def test_audit_engine_clean_on_real_round_path(mode):
    engine, policy, fleet = build_audited("flude", mode, device="cpu")
    report = audit_engine(engine, policy, fleet)
    assert report.ok(), report.summary()
    assert report.mode == mode and report.rounds == 2 and report.ops > 0
    assert "all contracts hold" in report.summary()
    assert report.transfer_ceiling["sync_copies"] == 0
    if mode == "offload":
        assert report.transfer_ceiling["h2d_async"] == 1


@pytest.mark.parametrize("policy", ["random", "mifa"])
def test_audit_engine_clean_on_host_side_baselines(policy):
    """A host-side baseline's read-back at its own boundary is its seam;
    the rest of its round is held to the contracts."""
    engine, pol, fleet = build_audited(policy, "cohort", device="cpu")
    report = audit_engine(engine, pol, fleet)
    assert report.ok(), report.summary()


def test_audit_cli(capsys):
    assert audit_main(["--policies", "flude", "--modes", "full",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "audit[flude/full]" in out and "0 finding(s)" in out


def _fake_engine(offload, **stats):
    ts = TransferStats()
    for k, v in stats.items():
        setattr(ts, k, v)
    return types.SimpleNamespace(offload=offload, transfer_stats=ts)


def test_transfer_ceiling_is_zero_without_offload_or_cache():
    zeros = {"d2h_async": 0, "h2d_async": 0,
             "pre_issued_reads": 0, "sync_copies": 0}
    assert transfer_ceiling(_fake_engine(None), True) == zeros
    assert transfer_ceiling(_fake_engine("host"), False) == zeros
    assert transfer_ceiling(_fake_engine("host"), True) == {
        "d2h_async": 2, "h2d_async": 1,
        "pre_issued_reads": 2, "sync_copies": 0}


def test_check_transfer_stats_flags_sync_copy_and_excess():
    eng = _fake_engine("host", d2h_async=6, h2d_async=3,
                       pre_issued_reads=6, sync_copies=0)
    assert check_transfer_stats(eng, rounds=3, uses_cache=True) == []
    eng = _fake_engine("host", d2h_async=7, sync_copies=1)
    bad = check_transfer_stats(eng, rounds=3, uses_cache=True)
    assert {f.message.split("=")[0] for f in bad} == {"d2h_async",
                                                      "sync_copies"}
    assert all(f.contract == "transfer" for f in bad)


# ---------------------------------------------------------------------------
# debug_checks runtime sanitisers
# ---------------------------------------------------------------------------

def test_round_guard_fires_on_nonfinite_model_and_loss():
    guard = RT.make_round_guard(8, with_idx=False)
    flags = guard({"w": torch.tensor([1.0, float("nan")])}, torch.zeros(4))
    with pytest.raises(RT.RoundCheckError,
                       match="round 5: non-finite value in global-model "
                             "leaf #0"):
        RT.check_round(flags, guard.messages, 5, "cpu")
    flags = guard({"w": torch.ones(2)},
                  torch.tensor([0.0, float("inf")]))
    with pytest.raises(RT.RoundCheckError, match="non-finite per-client"):
        RT.check_round(flags, guard.messages, 5, "cpu")
    flags = guard({"w": torch.ones(2)}, torch.zeros(4))
    RT.check_round(flags, guard.messages, 5, "cpu")      # clean


def test_round_guard_checks_cohort_index_bounds():
    guard = RT.make_round_guard(8, with_idx=True)
    # N == 8 is the legal pad sentinel; 9 and -1 are out of range
    flags = guard({"w": torch.ones(2)}, torch.zeros(4),
                  torch.tensor([0, 8]))
    RT.check_round(flags, guard.messages, 0, "cpu")
    for bad in ([0, 9], [-1, 3]):
        flags = guard({"w": torch.ones(2)}, torch.zeros(4),
                      torch.tensor(bad))
        with pytest.raises(RT.RoundCheckError, match="out of bounds"):
            RT.check_round(flags, guard.messages, 0, "cpu")


def test_round_guard_fires_in_an_engine_with_a_nan_model():
    engine = _small_engine(debug_checks=True)
    engine._template = tree_map(lambda t: torch.full_like(t, float("nan")),
                                engine._template)
    with pytest.raises(RT.RoundCheckError, match="round 0: non-finite"):
        engine.run("flude", diagnostics=False)


def test_rebuild_detector_on_a_fake_engine():
    eng = types.SimpleNamespace(_trainer=None, _dyn_cache={},
                                _server_steps={"k": 1}, _cut_fns={},
                                _metrics_fns={})
    det = RT.RebuildDetector(eng)
    det.check("a")                   # baseline
    det.check("a")                   # a repeat: fine
    eng._server_steps["k2"] = 2      # a new signature may build
    det.check("b")
    eng._cut_fns["x"] = 3            # a repeat may not
    with pytest.raises(RT.RoundCheckError, match="cut_fns 0 -> 1"):
        det.check("a")


def test_rebuild_detector_fires_on_a_changed_shape_not_on_a_repeat():
    """A repeat run of a debug_checks engine passes; the same run after
    the aggregation kernel's tile shape changed rebuilds the server
    step, and the detector names it."""
    engine = _small_engine(debug_checks=True)
    engine.run("flude", diagnostics=False)
    engine.run("flude", diagnostics=False)
    engine.run("flude", diagnostics=False, telemetry="basic")   # new level
    engine.fl_cfg = dataclasses.replace(engine.fl_cfg, agg_block_d=512)
    with pytest.raises(RT.RoundCheckError, match="server_steps 1 -> 2"):
        engine.run("flude", diagnostics=False)


@pytest.mark.parametrize("change", [
    dict(dynamics="bernoulli_host"), dict(),
    dict(cohort_size=8, pipeline_depth=2),
    dict(cohort_size=8, cache_offload="host")],
    ids=["host_loop", "full_scan", "cohort_depth2", "offload"])
def test_debug_checks_run_is_observation_only(monkeypatch, change):
    """Rows equal an unchecked run's; the guard reads once a round, and
    only through host_readback."""
    plain = _small_engine(**change).run("flude", diagnostics=False)
    counts = []
    real = ENG.host_readback

    def counting(device):
        counts.append(1)
        return real(device)

    import repro_torch.analysis.runtime as RTM
    monkeypatch.setattr(RTM, "host_readback", counting)
    checked = _small_engine(debug_checks=True, **change).run(
        "flude", diagnostics=False)
    assert _rows(checked) == _rows(plain)
    assert len(counts) == len(plain.acc)


def test_flconfig_accepts_the_slice_knobs_and_still_refuses_the_mesh():
    FLConfig(num_clients=16, selection_mode="thompson", telemetry="full",
             debug_checks=True, dynamics="markov", cohort_size=8,
             cache_offload="host", pipeline_depth=2)
    with pytest.raises(ValueError, match="selection_mode"):
        FLConfig(num_clients=16, selection_mode="greedy")
    for bad in (dict(mesh_shape=(2,)), dict(donate_buffers=True)):
        with pytest.raises(NotImplementedError, match="#17"):
            FLConfig(num_clients=16, **bad)
