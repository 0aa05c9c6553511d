"""Fleet models of the port: availability processes, traces, scenarios
and the adversary registry.

The typed ``init_state``/``step`` process API lives in
``repro_torch.fleet.api``; importing this package registers the built-in
processes (``bernoulli_host``, ``bernoulli``, ``markov``, ``sessions``,
``trace``) and the named scenario presets.
"""
from repro_torch.fleet.api import (DynamicsProcess,  # noqa: F401
                                   FleetDraw, FleetFeatures, FleetState,
                                   Uniform, availability_summary,
                                   available_dynamics, draw_noise,
                                   get_dynamics, make_dynamics,
                                   register_dynamics, simulate_availability)
from repro_torch.fleet import processes  # noqa: F401 — registers built-ins
from repro_torch.fleet import traces  # noqa: F401 — registers trace replay
from repro_torch.fleet.traces import (TraceProcess,  # noqa: F401
                                      synthesize_trace)
from repro_torch.fleet.processes import (BernoulliHostProcess,  # noqa: F401
                                         BernoulliProcess, MarkovProcess,
                                         SessionsProcess)
from repro_torch.fleet.scenarios import (Scenario,  # noqa: F401
                                         apply_scenario, available_scenarios,
                                         get_scenario, register_scenario)
from repro_torch.fleet.adversary import (Adversary,  # noqa: F401
                                         available_adversaries,
                                         get_adversary, make_adversary,
                                         register_adversary)
