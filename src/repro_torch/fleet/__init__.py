"""Fleet models of the port.  This slice holds the adversary registry; the
availability processes, traces and scenarios are ROADMAP Queue A #9."""
from repro_torch.fleet.adversary import (Adversary,  # noqa: F401
                                         available_adversaries,
                                         get_adversary, make_adversary,
                                         register_adversary)
