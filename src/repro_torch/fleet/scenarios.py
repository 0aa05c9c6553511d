"""Named fleet-dynamics scenario presets (``repro.fleet.scenarios``).

A ``Scenario`` binds a registered dynamics process to a concrete,
hashable parameterization.  ``apply_scenario(fl_cfg, name)`` returns an
``FLConfig`` with ``dynamics``/``dynamics_params`` set (and the attack,
for the adversarial presets); everything else about the run is
untouched::

    for name in available_scenarios():
        engine = FleetEngine(data, sim, apply_scenario(fl, name))
        hist = engine.run("flude")
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.fleet.adversary import get_adversary
from repro_torch.fleet.api import get_dynamics


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    dynamics: str                       # registered process name
    params: Tuple = ()                  # FLConfig.dynamics_params payload
    description: str = ""
    adversary: Optional[str] = None     # registered attack model (or None)
    adversary_params: Tuple = ()        # FLConfig.adversary_params payload

    def apply(self, fl_cfg):
        """FLConfig with this scenario's dynamics (and attack, if the
        scenario carries one) installed.  Benign scenarios leave the
        config's adversary untouched."""
        get_dynamics(self.dynamics)     # fail fast on unknown processes
        changes = dict(dynamics=self.dynamics,
                       dynamics_params=self.params)
        if self.adversary is not None:
            get_adversary(self.adversary)
            changes.update(adversary=self.adversary,
                           adversary_params=self.adversary_params)
        return dataclasses.replace(fl_cfg, **changes)


_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario, *,
                      allow_override: bool = False) -> Scenario:
    if scenario.name in _REGISTRY and not allow_override:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{', '.join(available_scenarios())}") from None


def available_scenarios():
    return sorted(_REGISTRY)


def apply_scenario(fl_cfg, name: str):
    return get_scenario(name).apply(fl_cfg)


# ---------------------------------------------------------------------------
# Presets (the reference's ten, field for field)
# ---------------------------------------------------------------------------

register_scenario(Scenario(
    "paper", "bernoulli_host",
    description="The paper's §5.2 setup verbatim: host-RNG i.i.d. "
                "Bernoulli availability — the golden trajectories."))

register_scenario(Scenario(
    "churn", "markov", params=(("mean_on", 5.0),),
    description="Two-state Markov on/off churn: availability correlated "
                "across rounds (~5-round sessions), stationary rates "
                "matching the paper's online rates."))

register_scenario(Scenario(
    "diurnal", "sessions",
    params=(("mean_on", 4.0), ("shape_on", 0.8), ("shape_gap", 0.8),
            ("amp", 0.6), ("period", 24.0), ("undep_mix", 0.5)),
    description="Heavy-tailed Weibull sessions with a strong day/night "
                "gap modulation — fleet availability follows the sun."))

register_scenario(Scenario(
    "flash-crowd", "trace",
    params=(("pattern", "flash-crowd"), ("horizon", 96.0),
            ("trace_seed", 11.0)),
    description="Sparse baseline availability punctuated by bursts where "
                "most of the fleet arrives at once."))

register_scenario(Scenario(
    "correlated-dropout", "trace",
    params=(("pattern", "correlated-dropout"), ("horizon", 96.0),
            ("trace_seed", 13.0)),
    description="Regional outage events: whole device clusters drop "
                "offline for consecutive rounds (cf. arXiv 2305.09856)."))

register_scenario(Scenario(
    "trace-replay", "trace",
    params=(("pattern", "diurnal"), ("horizon", 168.0),
            ("trace_seed", 17.0)),
    description="Replay of a week-long recorded availability matrix "
                "(synthesized diurnal stand-in) — the evaluation regime "
                "for production traces."))

register_scenario(Scenario(
    "sign-flip-10", "bernoulli",
    adversary="sign_flip", adversary_params=(("malicious_frac", 0.1),),
    description="Byzantine scaled reverse attack: 10% of the fleet "
                "uploads u' = g - 4(u - g).  The weighted mean limps; "
                "robust agg_rules shrug it off."))

register_scenario(Scenario(
    "sign-flip-20", "bernoulli",
    adversary="sign_flip", adversary_params=(("malicious_frac", 0.2),),
    description="Byzantine scaled reverse attack at 20% malicious "
                "clients — the weighted-mean update cancels almost "
                "exactly; the acceptance regime for robust rules."))

register_scenario(Scenario(
    "label-flip-20", "bernoulli",
    adversary="label_flip", adversary_params=(("malicious_frac", 0.2),),
    description="Data poisoning: 20% of clients train honestly on "
                "flipped labels (y' = K-1-y)."))

register_scenario(Scenario(
    "grad-scale-10", "bernoulli",
    adversary="grad_scale", adversary_params=(("malicious_frac", 0.1),),
    description="Boosting attack: 10% of clients upload "
                "u' = g + 10(u - g), dragging the mean far past the "
                "honest step."))
