"""Cross-device FL simulation of the port: fleet, policies, engine."""
from repro_torch.fl.simulator import Fleet, SimConfig  # noqa: F401
from repro_torch.fl.api import (Policy, RoundObservation,  # noqa: F401
                                RoundPlan, RoundReport, available_policies,
                                get_policy, make_policy, register_policy)
from repro_torch.fl.engine import FleetEngine, History, make_trainer  # noqa: F401,E501
from repro_torch.fl.runner import run_fl  # noqa: F401
