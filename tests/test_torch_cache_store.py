"""The port's host-offloaded C3 cache store (``FLConfig.cache_offload``),
on the CPU.

* ``HostCacheStore`` semantics — sparse rows, empty-slot gathers,
  write / clear / prune, owned copies — and seeded random round trips
  against a dense reference;
* the store's prune predicate and the port's ``expire_caches`` against
  the reference's ``expire_caches``;
* offload against resident in the port, bit-identical: every policy,
  ``"host"`` and ``"discard"`` with a bound the run never crosses, depths
  1 and 2, repeated runs, the stateful ``trust`` rule; and an offload run
  against the reference's offload run;
* the stream's contract: no synchronous copy, a fixed number of copies
  a round, (X, D) bytes, none without a cache, no extra uploads;
* the device / host residency split of ``server_step_memory``;
* ``"discard"`` dropping stale rows.
"""
import dataclasses

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
from repro.fl.simulator import SimConfig as RefSimConfig

import repro_torch.fl.engine as ENG
from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import cache_store as CS
from repro_torch.core import caching as C
from repro_torch.data.synthetic import federated_classification
from repro_torch.fl import FleetEngine, SimConfig

from torch_dynamics_ref import reference_explore_uniforms, reference_noise

N, ROUNDS = 32, 3
SIM = SimConfig(num_clients=N, rounds=ROUNDS, local_steps=2, batch_size=8,
                seed=3)
FL = FLConfig(num_clients=N, clients_per_round=8, dynamics="markov",
              cohort_size=8)
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


@pytest.fixture(scope="module")
def data():
    return federated_classification(N, seed=4, n_per_client=16)


def _run(data, fl, policy="flude", sim=SIM, **kw):
    return FleetEngine(data, sim, fl, device="cpu").run(
        policy, diagnostics=False, **kw)


def _for(policy, fl=FL):
    """``fl`` with the cohort a policy needs: N for the select-all two."""
    return fl if policy not in UNBOUNDED \
        else dataclasses.replace(fl, cohort_size=N)


def _template():
    return {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.zeros(4, np.float32)}


# ---------------------------------------------------------------------------
# HostCacheStore
# ---------------------------------------------------------------------------

def test_store_empty_gather_is_zero():
    store = CS.HostCacheStore(_template(), num_clients=8)
    got = store.gather(np.array([0, 3, 8]))      # 8 = sentinel
    assert got["w"].shape == (3, 2, 3) and got["b"].shape == (3, 4)
    assert not got["w"].any() and not got["b"].any()
    assert len(store) == 0 and store.nbytes == 0
    assert store.row_bytes == 10 * 4


def test_store_write_fetch_clear_roundtrip():
    store = CS.HostCacheStore(_template(), num_clients=8)
    block = {"w": np.random.default_rng(0).normal(size=(3, 2, 3))
             .astype(np.float32),
             "b": np.ones((3, 4), np.float32)}
    idx = np.array([1, 4, 8])                    # last row is the sentinel
    store.apply(idx, write=np.array([True, True, True]),
                clear=np.zeros(3, bool), stamps=np.array([0, 0, 0]),
                block=block, current_round=0)
    assert len(store) == 2                       # sentinel write dropped
    assert store.nbytes == 2 * store.row_bytes
    got = store.gather(np.array([4, 1, 2]))
    np.testing.assert_array_equal(got["w"][0], block["w"][1])
    np.testing.assert_array_equal(got["w"][1], block["w"][0])
    np.testing.assert_array_equal(got["b"][1], block["b"][0])
    assert not got["w"][2].any()                 # never-written row
    # rows are owned copies, not views into the block
    block["w"][:] = -1.0
    assert not (store.gather(np.array([1]))["w"] == -1.0).any()
    # a gather into a given (X, D) buffer writes it in place
    out = np.full((2, 10), 7.0, np.float32)
    view = store.gather(np.array([8, 4]), out=out)
    assert not out[0].any() and view["w"].base is not None
    store.apply(np.array([1]), write=np.array([False]),
                clear=np.array([True]), stamps=np.array([0]),
                block=np.zeros((1, 10), np.float32), current_round=1)
    assert len(store) == 1 and store.stamp_of(1) is None
    assert store.stamp_of(4) == 0


def test_store_prune_drops_stale_rows():
    store = CS.HostCacheStore(_template(), num_clients=8,
                              staleness_bound=2)
    block = {"w": np.ones((2, 2, 3), np.float32),
             "b": np.ones((2, 4), np.float32)}
    store.apply(np.array([0, 5]), write=np.array([True, True]),
                clear=np.zeros(2, bool), stamps=np.array([0, 3]),
                block=block, current_round=2)   # 2 - 0 <= 2: both stay
    assert len(store) == 2
    store.prune(5)           # 5 - 0 > 2 drops row 0; 5 - 3 <= 2 keeps 5
    assert len(store) == 1 and store.stamp_of(0) is None
    assert store.stamp_of(5) == 3


def test_store_refuses_a_mixed_dtype_template():
    with pytest.raises(ValueError, match="one dtype"):
        CS.HostCacheStore({"a": np.zeros(2, np.float32),
                           "b": np.zeros(2, np.int32)}, 4)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_store_roundtrip_random_sequences(seed):
    """After any sequence of applies a gather reads the dense
    reference's row wherever its metadata says "live cache" and zeros
    everywhere else — sentinel, cleared and expired rows included."""
    rng = np.random.default_rng(seed)
    n, x = int(rng.integers(4, 20)), int(rng.integers(1, 8))
    bound = None if seed % 2 else int(rng.integers(1, 4))
    template = _template()
    store = CS.HostCacheStore(template, n, staleness_bound=bound)
    ref_rows = {k: np.zeros((n,) + v.shape, v.dtype)
                for k, v in template.items()}
    ref_stamp = np.full(n, -1, np.int64)
    for rnd in range(6):
        ids = rng.choice(n, size=min(x, n), replace=False)
        k_live = int(rng.integers(0, len(ids) + 1))
        idx = np.full(x, n, np.int64)
        idx[:k_live] = np.sort(ids[:k_live])
        op = rng.integers(0, 3, size=x)          # 0 write, 1 clear, 2 none
        write, clear = op == 0, op == 1
        stamps = rng.integers(0, rnd + 1, size=x)
        block = {k: rng.normal(size=(x,) + v.shape).astype(v.dtype)
                 for k, v in template.items()}
        store.apply(idx, write, clear, stamps, block, rnd)
        for k in range(x):
            cid = int(idx[k])
            if cid >= n:
                continue
            if write[k]:
                for name in ref_rows:
                    ref_rows[name][cid] = block[name][k]
                ref_stamp[cid] = stamps[k]
            elif clear[k]:
                ref_stamp[cid] = -1
        if bound is not None:
            ref_stamp[(rnd - ref_stamp > bound) & (ref_stamp >= 0)] = -1
        probe = rng.integers(0, n + 1, size=5)   # n = the sentinel
        got = store.gather(probe)
        for name in ref_rows:
            for k, cid in enumerate(probe):
                cid = int(cid)
                want = ref_rows[name][cid] \
                    if cid < n and ref_stamp[cid] >= 0 \
                    else np.zeros_like(ref_rows[name][0])
                np.testing.assert_array_equal(got[name][k], want,
                                              err_msg=f"r{rnd} {name}")
    assert len(store) == int((ref_stamp >= 0).sum())


@pytest.mark.parametrize("rnd,bound", [(9, 3), (4, 1), (6, 6)])
def test_store_prune_and_expiry_match_reference_expiry(rnd, bound):
    """The store's prune, the port's ``expire_caches`` and the
    reference's share one predicate, ``rnd - stamp > bound``: a row is
    pruned iff its metadata expires, so the planner can never resume a
    pruned row."""
    stamps = np.array([-1, 0, 2, 5, 8, 9], np.int32)
    progress = np.full(6, 0.5, np.float32)
    want = ref_core.expire_caches(
        ref_core.ClientCaches({}, jnp.asarray(progress),
                              jnp.asarray(stamps)), rnd, bound)
    got = C.expire_caches(C.ClientCaches(
        {}, with_spare_row(torch.from_numpy(progress)),
        with_spare_row(torch.from_numpy(stamps))), rnd, bound)
    np.testing.assert_array_equal(got.round_stamp.numpy(),
                                  np.asarray(want.round_stamp))
    np.testing.assert_array_equal(got.progress.numpy(),
                                  np.asarray(want.progress))
    store = CS.HostCacheStore(_template(), 6, staleness_bound=bound)
    live = stamps >= 0
    store.apply(np.arange(6), live, np.zeros(6, bool), stamps,
                np.ones((6, 10), np.float32), current_round=0)
    store.prune(rnd)
    kept = np.array([store.stamp_of(i) is not None for i in range(6)])
    np.testing.assert_array_equal(kept, np.asarray(want.round_stamp) >= 0)


# ---------------------------------------------------------------------------
# Offload against resident (bit-identical)
# ---------------------------------------------------------------------------

def _same_rows(a, b, ctx=""):
    assert a.to_json() == b.to_json(), ctx


@pytest.mark.parametrize("mode", ["host", "discard"])
@pytest.mark.parametrize("policy", POLICIES)
def test_offload_rows_equal_resident_rows(data, policy, mode):
    """``"host"``, and ``"discard"`` with a bound the run never crosses,
    at depths 1 and 2: the resident cohort rows, bit for bit."""
    fl = _for(policy)
    resident = _run(data, fl, policy)
    for depth in (1, 2):
        off = dataclasses.replace(fl, cache_offload=mode, pipeline_depth=depth,
                                  cache_staleness_bound=ROUNDS + 10)
        _same_rows(resident, _run(data, off, policy), (mode, depth))


@pytest.mark.parametrize("x", [12, N])
def test_offload_padded_cohort(data, x):
    resident = _run(data, FL, "flude")
    fl = dataclasses.replace(FL, cohort_size=x, cache_offload="host")
    _same_rows(resident, _run(data, fl, "flude"), x)


def test_repeated_runs_reset_the_store(data):
    fl = dataclasses.replace(FL, cache_offload="host")
    engine = FleetEngine(data, SIM, fl, device="cpu")
    h1 = engine.run("flude", diagnostics=False)
    h2 = engine.run("flude", diagnostics=False)
    _same_rows(h1, h2, "rerun")
    _same_rows(_run(data, FL, "flude"), h2, "resident")


def test_offload_threads_the_stateful_rule(data):
    fl = dataclasses.replace(FL, agg_rule="trust")
    resident = FleetEngine(data, SIM, fl, device="cpu").run("flude")
    off = FleetEngine(data, SIM, dataclasses.replace(
        fl, cache_offload="host"), device="cpu").run("flude")
    _same_rows(resident, off, "trust")
    assert off.trust.shape == (N,)
    np.testing.assert_array_equal(resident.trust, off.trust)


def test_offload_run_matches_reference():
    """An offload run against the reference's offload run from its random
    numbers: ``selected``, ``received`` and ``comm_mb`` exact, wall clock
    within 1e-5, accuracy within 4/2048."""
    fl = dict(num_clients=N, clients_per_round=8, dynamics="markov",
              cohort_size=8, cache_offload="host")
    sim = dict(num_clients=N, rounds=ROUNDS, local_steps=2, batch_size=8,
               seed=3)
    ref = RefEngine(ref_data(N, seed=4, n_per_client=16),
                    RefSimConfig(**sim), RefFLConfig(**fl)).run(
        "flude", diagnostics=False)
    template = jax.device_get(RefCLF.init_classifier(
        jax.random.key(sim["seed"] + 1), dim=32, num_classes=10,
        hidden=128, depth=2))
    us = reference_explore_uniforms(sim["seed"], ROUNDS, N)
    noise = reference_noise("markov", sim["seed"], ROUNDS, N)
    ours = FleetEngine(federated_classification(N, seed=4, n_per_client=16),
                       SimConfig(**sim), FLConfig(**fl),
                       template=params_from_jax(template), device="cpu").run(
        "flude", explore_uniforms=lambda r: us[r],
        dynamics_noise=lambda r: noise[r], diagnostics=False)
    assert (ours.selected, ours.received, ours.comm_mb) == \
        (ref.selected, ref.received, ref.comm_mb)
    np.testing.assert_allclose(ours.wall_clock, ref.wall_clock, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ours.acc, ref.acc, rtol=0, atol=ACC_TOL)


# ---------------------------------------------------------------------------
# The stream's contract
# ---------------------------------------------------------------------------

def test_stream_copies_a_fixed_number_a_round_and_never_synchronously(
        data):
    """Per round: one index copy and one write-back copy to the host, one
    block copy to the device, two reads of queued copies; no synchronous
    copy; the block is (X, D), the write-back (X, D) plus (4, X) int32
    metadata, the index (X,) int64."""
    fl = dataclasses.replace(FL, cache_offload="host")
    engine = FleetEngine(data, SIM, fl, device="cpu")
    engine.run("flude", diagnostics=False)
    per_run = []
    for rounds in (1, 3):
        engine.transfer_stats.reset()
        engine.run("flude", rounds=rounds, diagnostics=False)
        per_run.append(engine.transfer_stats.snapshot())
    x, row = FL.cohort_size, engine.cache_store.row_bytes
    for rounds, s in zip((1, 3), per_run):
        assert s == {"h2d_async": rounds, "d2h_async": 2 * rounds,
                     "h2d_bytes": rounds * x * row,
                     "d2h_bytes": rounds * (x * row + 16 * x + 8 * x),
                     "pre_issued_reads": 2 * rounds, "sync_copies": 0}, s
    assert per_run[1]["h2d_bytes"] < 3 * N * row


def test_no_stream_copies_without_a_cache(data):
    """A policy that never caches skips the stream: the trainer gets a
    constant zero block."""
    engine = FleetEngine(data, SIM, dataclasses.replace(
        FL, cache_offload="host"), device="cpu")
    engine.run("random", diagnostics=False)
    assert engine.transfer_stats.snapshot() == CS.TransferStats().snapshot()
    assert len(engine.cache_store) == 0


def test_offload_adds_no_per_round_uploads(data, monkeypatch):
    counts = {"n": 0}
    orig = ENG.place_per_client

    def counting(arr, device):
        counts["n"] += 1
        return orig(arr, device)
    monkeypatch.setattr(ENG, "place_per_client", counting)
    per_path = {}
    for label, fl in (("resident", FL), ("offload", dataclasses.replace(
            FL, cache_offload="host"))):
        engine = FleetEngine(data, SIM, fl, device="cpu")
        engine.run("flude", diagnostics=False)
        per_run = []
        for rounds in (1, 3):
            counts["n"] = 0
            engine.run("flude", rounds=rounds, diagnostics=False)
            per_run.append(counts["n"])
        assert per_run[0] == per_run[1], (label, per_run)
        per_path[label] = per_run[0]
    assert per_path["offload"] == per_path["resident"], per_path


# ---------------------------------------------------------------------------
# Memory profile
# ---------------------------------------------------------------------------

def test_server_step_memory_reports_the_residency_split(data):
    x = FL.cohort_size
    resident = FleetEngine(data, SIM, FL, device="cpu")
    offload = FleetEngine(data, SIM, dataclasses.replace(
        FL, cache_offload="host"), device="cpu")
    mr, mo = resident.server_step_memory(), offload.server_step_memory()
    row = offload.cache_store.row_bytes
    assert mr["cache_host_bytes"] == 0
    assert mr["cache_device_bytes"] == N * 8 + N * row
    assert mo["cache_device_bytes"] == N * 8 + x * row
    assert mo["cache_host_bytes"] == 0          # nothing stored yet
    assert mo["peak_live_bytes"] < mr["peak_live_bytes"]
    offload.run("flude", diagnostics=False)
    after = offload.server_step_memory()
    assert after["cache_host_bytes"] == len(offload.cache_store) * row > 0
    assert mr["rule_state_bytes"] == 0
    trust = FleetEngine(data, SIM, dataclasses.replace(
        FL, agg_rule="trust", cache_offload="host"), device="cpu")
    assert trust.server_step_memory()["rule_state_bytes"] == N * 4


# ---------------------------------------------------------------------------
# "discard"
# ---------------------------------------------------------------------------

def test_discard_prunes_stale_rows(data):
    sim = dataclasses.replace(SIM, rounds=8)
    fl = dataclasses.replace(FL, cache_offload="discard",
                             cache_staleness_bound=1)
    engine = FleetEngine(data, sim, fl, device="cpu")
    engine.run("flude", diagnostics=False)
    # the run-end flush prunes at round ``rounds``
    for cid in list(engine.cache_store._stamps):
        assert sim.rounds - engine.cache_store.stamp_of(cid) <= 1
    loose = FleetEngine(data, sim, dataclasses.replace(
        fl, cache_staleness_bound=64), device="cpu")
    loose.run("flude", diagnostics=False)
    assert len(engine.cache_store) < len(loose.cache_store)
    stamps = engine._last_caches.round_stamp
    assert int(((sim.rounds - 1 - stamps > 1) & (stamps >= 0)).sum()) == 0
