"""The port's FLUDE round loop as a whole, against the JAX reference.

The golden setup of ``tests/golden/history_prerefactor.json`` (N=24, 8 per
round, 5 rounds) runs through JAX's ``run_fl("flude", ...)`` live in this
process and through ``repro_torch``'s engine on the CPU, with the
reference's initial parameters and its ``jax.random`` explore uniforms
carried across.  Also: the configs copy the reference field for field, the
entry points refuse to drift onto the CPU, and the port imports no JAX.
"""
import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as RefFLConfig
from repro.data.synthetic import federated_classification as ref_data
from repro.fl import classifier as RefCLF
from repro.fl.runner import run_fl as ref_run_fl
from repro.fl.simulator import Fleet as RefFleet, SimConfig as RefSimConfig

from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import federated_classification
from repro_torch.fl import FleetEngine, History, run_fl
from repro_torch.fl.simulator import Fleet, SimConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "history_prerefactor.json"
# accuracy is over 2048 test samples: a few flipped predictions from fp32
# rounding differences in five rounds of local SGD are tolerated
ACC_TOL = 4 / 2048


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


def reference_explore_uniforms(seed: int, rounds: int, n: int):
    """The reference's per-round explore noise: ``rng = key(seed)``, then
    each round ``rng, k = split(rng)`` and ``uniform(k, (N,))``."""
    rng = jax.random.key(seed)
    out = []
    for _ in range(rounds):
        rng, k = jax.random.split(rng)
        out.append(np.asarray(jax.random.uniform(k, (n,))))
    return out


@pytest.fixture(scope="module")
def golden_runs():
    sim, fl, dkw = _golden_setup()
    n = sim["num_clients"]
    rdata = ref_data(n, **dkw)
    ref = ref_run_fl("flude", rdata, RefSimConfig(**sim), RefFLConfig(**fl))
    sim_cfg = SimConfig(**sim)
    template = jax.device_get(RefCLF.init_classifier(
        jax.random.key(sim_cfg.seed + 1), dim=rdata.x.shape[-1],
        num_classes=rdata.num_classes, hidden=sim_cfg.model_hidden,
        depth=sim_cfg.model_depth))
    us = reference_explore_uniforms(sim_cfg.seed, sim_cfg.rounds, n)
    engine = FleetEngine(federated_classification(n, **dkw), sim_cfg,
                         FLConfig(**fl), template=params_from_jax(template),
                         device="cpu")
    port = engine.run("flude", explore_uniforms=lambda rnd: us[rnd])
    return ref, port


def test_engine_matches_reference_trajectory(golden_runs):
    ref, port = golden_runs
    assert port.selected == ref.selected
    assert port.received == ref.received
    np.testing.assert_array_equal(port.part_count,
                                  np.asarray(ref.part_count))
    np.testing.assert_allclose(port.wall_clock, ref.wall_clock, atol=1e-5)
    np.testing.assert_allclose(port.comm_mb, ref.comm_mb, atol=1e-5)
    np.testing.assert_allclose(port.acc, ref.acc, atol=ACC_TOL)
    assert port.eval_mask == ref.eval_mask


def test_engine_final_params_match_reference(golden_runs):
    ref, port = golden_runs
    # fp32 SGD over five rounds with another summation order: 1e-4
    want = jax.device_get(ref.final_params)
    for layer in want:
        for name in want[layer]:
            np.testing.assert_allclose(
                port.final_params[layer][name].numpy(), want[layer][name],
                atol=1e-4)
    np.testing.assert_allclose(port.per_class_acc, ref.per_class_acc,
                               atol=0.01)
    np.testing.assert_allclose(port.per_client_acc, ref.per_client_acc,
                               atol=2 / 32)


def test_data_and_fleet_copies_draw_like_the_reference():
    a = federated_classification(6, seed=5, n_per_client=16, n_test=64)
    b = ref_data(6, seed=5, n_per_client=16, n_test=64)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    sim = dict(num_clients=50, seed=9)
    f, g = Fleet(SimConfig(**sim)), RefFleet(RefSimConfig(**sim))
    for name in ("undep", "online_rate", "steps_per_sec", "bandwidth",
                 "battery", "stability"):
        np.testing.assert_array_equal(getattr(f, name), getattr(g, name))
    steps = np.arange(50, dtype=np.int32) % 9
    for _ in range(3):       # the per-round draw order
        np.testing.assert_array_equal(f.online_mask(), g.online_mask())
        np.testing.assert_array_equal(f.failure_draw(steps / 8),
                                      g.failure_draw(steps / 8))
        np.testing.assert_array_equal(f.failure_step(steps),
                                      g.failure_step(steps))
    done = f.round_times(steps, steps > 3, steps, steps > 1)
    np.testing.assert_array_equal(
        done, g.round_times(steps, steps > 3, steps, steps > 1))


@pytest.mark.parametrize("ours,theirs", [(FLConfig, RefFLConfig),
                                         (SimConfig, RefSimConfig)])
def test_configs_copy_the_reference_field_for_field(ours, theirs):
    mine = {f.name: f.default for f in dataclasses.fields(ours)}
    ref = {f.name: f.default for f in dataclasses.fields(theirs)}
    assert list(mine) == list(ref)
    # the one documented exception: the aggregation backend names
    if ours is FLConfig:
        assert (mine.pop("agg_impl"), ref.pop("agg_impl")) == ("cuda", "xla")
    assert mine == ref


@pytest.mark.parametrize("override", [
    dict(cache_offload="host"), dict(dynamics="sessions"),
    dict(mesh_shape=(2,)), dict(cohort_size=8), dict(telemetry="basic"),
    dict(dynamics="markov"), dict(selection_mode="thompson"),
    dict(pipeline_depth=2), dict(donate_buffers=True),
    dict(debug_checks=True)])
def test_config_values_outside_the_slice_name_their_queue_item(override):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A #"):
        FLConfig(num_clients=16, **override)


def test_agg_impl_takes_the_port_backends_only():
    FLConfig(agg_impl="torch")
    with pytest.raises(ValueError, match="agg_impl"):
        FLConfig(agg_impl="xla")


def test_entry_points_refuse_to_drift_onto_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = federated_classification(4, seed=0, n_per_client=8, n_test=16)
    sim, fl = SimConfig(num_clients=4, rounds=1), FLConfig(num_clients=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetEngine(data, sim, fl)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fl("flude", data, sim, fl)
    assert len(run_fl("flude", data, sim, fl, device="cpu").acc) == 1


def test_engine_reruns_reproduce_and_match_run_fl():
    data = federated_classification(12, seed=1, n_per_client=16, n_test=64)
    sim = SimConfig(num_clients=12, rounds=3, local_steps=3, seed=4)
    fl = FLConfig(num_clients=12, clients_per_round=5)
    engine = FleetEngine(data, sim, fl, device="cpu")
    a = engine.run("flude")
    b = engine.run("flude")         # caches of run a are reset in place
    c = run_fl("flude", data, sim, fl, device="cpu")
    assert a.to_json() == b.to_json() == c.to_json()
    assert History.from_json(a.to_json()).to_json() == a.to_json()
    assert a.time_to_accuracy(0.0) == a.wall_clock[0]


def test_default_template_follows_the_reference_law():
    """Without a template the engine draws the classifier from a seeded
    ``torch.Generator``: the reference's shapes and law (fan-in-scaled
    normal weights, zero biases), not its numbers."""
    data = federated_classification(4, seed=0, n_per_client=8, n_test=16)
    sim = SimConfig(num_clients=4, seed=5)
    ours = FleetEngine(data, sim, FLConfig(num_clients=4),
                       device="cpu")._template
    ref = jax.device_get(RefCLF.init_classifier(
        jax.random.key(sim.seed + 1), dim=32, num_classes=10))
    for layer in ref:
        assert not ours[layer]["b"].any()
        w = ours[layer]["w"]
        assert w.shape == ref[layer]["w"].shape and w.dtype == torch.float32
        np.testing.assert_allclose(float(w.std()) * w.shape[0] ** 0.5, 1.0,
                                   atol=0.15)
    again = FleetEngine(data, sim, FLConfig(num_clients=4),
                        device="cpu")._template
    assert torch.equal(again["h0"]["w"], ours["h0"]["w"])


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_repro():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_port_imports_with_jax_blocked():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(
            ROOT / "src" / "repro_torch").with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(" f"{mods!r}" "))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
