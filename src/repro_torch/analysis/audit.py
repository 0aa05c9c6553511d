"""Invariant auditor of the engine's round path.

The reference lowers each jitted round dispatch and checks its compiled
HLO.  The port's round is eager, so the auditor runs it: after one
unchecked warm-up round (construction — building the trainer, placing
the data, memoising the round functions — is not the round path), it
runs two rounds of the engine under :class:`~repro_torch.analysis.
op_checks.OpChecks` and :class:`~repro_torch.analysis.op_checks.
InPlaceWatch` and checks:

1. no wait for the card outside ``host_readback`` (host-op),
2. no float64 outside the round ledger's row (no-f64),
3. the cohort path's in-place writes keep their storage (in-place),
4. the cache stream's host transfers within the static per-round
   ceiling, with no synchronous copy (transfer).

A host-side baseline reads its observation and report back at its own
boundary, by design; the auditor runs its ``plan`` / ``observe`` as such
a seam (inside ``host_readback``), and checks everything else.

Run the registered-policy matrix from the CLI::

    PYTHONPATH=src python -m repro_torch.analysis.audit
    PYTHONPATH=src python -m repro_torch.analysis.audit --policies flude \\
        --modes offload --device cpu

or audit a live engine in tests::

    report = audit_engine(engine, "flude")
    report.raise_on_findings()
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.op_checks import Finding, InPlaceWatch, OpChecks
from repro_torch.device import host_readback

MODES = ("full", "cohort", "offload")


@dataclasses.dataclass
class AuditReport:
    policy: str
    mode: str                    # "full" | "cohort" | "offload"
    rounds: int                  # rounds run under the checks
    ops: int                     # aten ops those rounds ran
    findings: List[Finding]
    transfer_ceiling: Dict[str, int]

    def ok(self) -> bool:
        return not self.findings

    def summary(self) -> str:
        head = (f"audit[{self.policy}/{self.mode}] {self.rounds} rounds, "
                f"{self.ops} ops")
        if self.ok():
            return head + ": all contracts hold"
        lines = [head + f": {len(self.findings)} finding(s)"]
        lines += [f"  - {f}" for f in self.findings]
        return "\n".join(lines)

    def raise_on_findings(self) -> None:
        if not self.ok():
            raise AssertionError(self.summary())


def _mode(engine) -> str:
    if engine.cohort is None:
        return "full"
    return "offload" if engine.offload is not None else "cohort"


# ---------------------------------------------------------------------------
# Static per-round transfer ceiling
# ---------------------------------------------------------------------------

def transfer_ceiling(engine, uses_cache: bool) -> Dict[str, int]:
    """Static per-round ceiling of the engine's cache-stream transfers.

    The offload stream's steady round is exactly one queued d2h copy of
    the cohort index and one of the staged write-back, one queued h2d
    copy of the fetched (X, D) block, two host reads of copies queued
    earlier (the index, the write-back's drain), and no synchronous
    copy.  Resident caches, or a policy that never caches, move
    nothing."""
    if engine.offload is None or not uses_cache:
        return {"d2h_async": 0, "h2d_async": 0,
                "pre_issued_reads": 0, "sync_copies": 0}
    return {"d2h_async": 2, "h2d_async": 1,
            "pre_issued_reads": 2, "sync_copies": 0}


def check_transfer_stats(engine, rounds: int, uses_cache: bool,
                         stats: Optional[dict] = None,
                         where: str = "cache_stream") -> List[Finding]:
    """``engine.transfer_stats`` (or ``stats``, a snapshot's counts over
    ``rounds`` rounds) against the static ceiling."""
    ceiling = transfer_ceiling(engine, uses_cache)
    if stats is None:
        stats = engine.transfer_stats.snapshot()
    findings: List[Finding] = []
    for key, per_round in ceiling.items():
        bound = 0 if key == "sync_copies" else per_round * rounds
        got = stats[key]
        if got > bound:
            findings.append(Finding(
                where, "transfer",
                f"{key}={got} after {rounds} round(s) exceeds the static "
                f"ceiling {bound} ({per_round}/round) — counts: {stats}"))
    return findings


# ---------------------------------------------------------------------------
# The audit
# ---------------------------------------------------------------------------

class _BoundaryPolicy:
    """A host-side policy whose ``plan`` / ``observe`` run inside
    ``host_readback``: the read-back at its own boundary is its
    documented seam.  Everything else is the wrapped policy's."""

    def __init__(self, policy, device):
        self._policy = policy
        self._device = device

    def __getattr__(self, name):
        return getattr(self._policy, name)

    def plan(self, state, obs):
        with host_readback(self._device):
            return self._policy.plan(state, obs)

    def observe(self, state, plan, report):
        with host_readback(self._device):
            return self._policy.observe(state, plan, report)


def audit_engine(engine, policy, fleet=None, *,
                 rounds: int = 2) -> AuditReport:
    """Run ``rounds`` rounds of ``engine`` under ``policy`` (a registered
    name or a policy instance) after one warm-up round, under the op
    checks; returns an :class:`AuditReport` (``raise_on_findings()``
    fails with every broken contract)."""
    from repro_torch.fl.api import make_policy
    from repro_torch.fl.simulator import Fleet

    if fleet is None:
        fleet = engine._fleet if engine._fleet is not None \
            else Fleet(engine.sim_cfg)
    if isinstance(policy, str):
        policy = make_policy(policy, engine.sim_cfg, engine.fl_cfg, fleet,
                             device=engine.device)
    run_policy = policy if policy.plans_on_device \
        else _BoundaryPolicy(policy, engine.device)
    engine.run(run_policy, rounds=1, diagnostics=False, telemetry=False)

    watch = InPlaceWatch(engine)
    before = engine.transfer_stats.snapshot()
    try:
        with OpChecks() as oc:
            engine.run(run_policy, rounds=rounds, diagnostics=False,
                       telemetry=False)
    finally:
        findings = oc.findings + watch.close()
    after = engine.transfer_stats.snapshot()
    delta = {k: after[k] - before[k] for k in after}
    findings += check_transfer_stats(engine, rounds, policy.uses_cache,
                                     stats=delta)
    return AuditReport(policy=policy.name, mode=_mode(engine),
                       rounds=rounds, ops=oc.ops, findings=findings,
                       transfer_ceiling=transfer_ceiling(
                           engine, policy.uses_cache))


# ---------------------------------------------------------------------------
# Registered-policy matrix
# ---------------------------------------------------------------------------

#: toy-fleet sizes (the reference's auditor's)
_AUDIT_N = 48
_AUDIT_X = 16


def build_audited(policy_name: str, mode: str, device=None):
    """A small device-loop engine (markov churn) for one policy and mode;
    a policy that may select more than X clients gets X = N."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import federated_classification
    from repro_torch.fl import FleetEngine, SimConfig
    from repro_torch.fl.api import make_policy
    from repro_torch.fl.simulator import Fleet

    N = _AUDIT_N
    data = federated_classification(N, num_classes=5, dim=12,
                                    n_per_client=20, n_test=40, seed=4)
    sim = SimConfig(num_clients=N, rounds=2, local_steps=2, batch_size=8,
                    model_hidden=24, model_depth=1, seed=3)
    kw = dict(num_clients=N, clients_per_round=_AUDIT_X,
              dynamics="markov")
    if mode in ("cohort", "offload"):
        kw["cohort_size"] = _AUDIT_X
    if mode == "offload":
        kw["cache_offload"] = "host"

    def make(kw):
        fl = FLConfig(**kw)
        engine = FleetEngine(data, sim, fl, device=device)
        fleet = Fleet(sim)
        return engine, make_policy(policy_name, sim, fl, fleet,
                                   device=engine.device), fleet

    engine, policy, fleet = make(kw)
    if engine.cohort is not None \
            and policy.selection_bound() > engine.cohort:
        kw["cohort_size"] = N
        engine, policy, fleet = make(kw)
    return engine, policy, fleet


def run_matrix(policies: Optional[Sequence[str]] = None,
               modes: Sequence[str] = MODES,
               device=None) -> List[AuditReport]:
    """Audit every registered policy's round path in each mode."""
    from repro_torch.fl.api import available_policies

    if policies is None:
        policies = available_policies()
    reports = []
    for name in policies:
        for mode in modes:
            engine, policy, fleet = build_audited(name, mode, device)
            reports.append(audit_engine(engine, policy, fleet))
    return reports


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="Run the round path under the op checks: no wait "
                    "outside host_readback, no float64 outside the "
                    "ledger row, in-place cohort writes, the transfer "
                    "ceiling.")
    parser.add_argument("--policies", nargs="*", default=None,
                        help="registered policy names (default: all)")
    parser.add_argument("--modes", nargs="*", default=MODES,
                        choices=MODES)
    parser.add_argument("--device", default=None,
                        help="the engines' device (default: the CUDA "
                             "card; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    reports = run_matrix(args.policies, tuple(args.modes), args.device)
    bad = 0
    for r in reports:
        print(r.summary())
        bad += len(r.findings)
    print(f"audited {len(reports)} policy/mode combinations, "
          f"{bad} finding(s)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
