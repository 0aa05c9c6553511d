"""Typed fleet-dynamics process API of the port (``repro.fleet.api``):
``FleetFeatures``, ``FleetState``, ``FleetDraw``, ``DynamicsProcess`` and
its registry.

* ``FleetFeatures`` — the static per-device population (undependability,
  online rate, compute speed, bandwidth, battery, stability), placed on
  the engine's device once;
* ``FleetState``    — the carry threaded through rounds: a round clock
  ``t`` (a 0-d int32 tensor) plus a process-specific ``slot``;
* ``FleetDraw``     — one round's draw: online mask, failure variates
  (mask at any work fraction via ``failure_mask``), interruption point
  (``interruption_step``), bandwidth and battery;
* ``DynamicsProcess`` — ``init_state(noise)`` / ``step(state, noise)``,
  pure tensor functions of named uniforms.

Randomness is a seam, not a generator: each process declares the (N,)
uniforms its ``init_state`` and ``step`` consume (``init_noise`` /
``step_noise``, each a ``Uniform(name, low, high)``), and the caller hands
them in as a dict of tensors.  The engine draws them from a
``torch.Generator`` on its device (``draw_noise``); a test hands in the
reference's ``jax.random`` numbers, so both packages run the same draws.

Failure coupling: a process emits one uniform ``fail_u`` and a per-round
full-exposure failure probability ``fail_p``; the mask at work fraction
``w`` is ``fail_u < 1 - (1 - fail_p)**w`` (monotone in ``w``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core.caching import take_rows


# ---------------------------------------------------------------------------
# Static population features
# ---------------------------------------------------------------------------

class FleetFeatures(NamedTuple):
    """Static per-device tensors on one device (each (N,) float32)."""
    undep: torch.Tensor           # full-exposure failure probability
    online_rate: torch.Tensor     # long-run availability target
    steps_per_sec: torch.Tensor   # compute speed (device tier)
    bandwidth: torch.Tensor       # WiFi bandwidth, megabits/s
    battery: torch.Tensor         # [0, 1]
    stability: torch.Tensor       # [0, 1] network stability

    @classmethod
    def from_fleet(cls, fleet, device) -> "FleetFeatures":
        """Place the numpy ``Fleet`` population on ``device`` as float32
        (the reference's cast) — a one-time hand-off."""
        from repro_torch.fl.simulator import place_per_client

        def put(a):
            return place_per_client(np.asarray(a, np.float32), device)

        return cls(undep=put(fleet.undep), online_rate=put(fleet.online_rate),
                   steps_per_sec=put(fleet.steps_per_sec),
                   bandwidth=put(fleet.bandwidth), battery=put(fleet.battery),
                   stability=put(fleet.stability))

    @property
    def num_clients(self) -> int:
        return self.undep.shape[0]

    @property
    def device(self) -> torch.device:
        return self.undep.device


# ---------------------------------------------------------------------------
# Round state / draw
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetState:
    """Fleet-dynamics carry: a round clock + the process slot."""
    t: Any                     # 0-d int32 tensor
    slot: Any = ()             # process-specific ((N,)-leading tensors)


@dataclasses.dataclass(frozen=True)
class FleetDraw:
    """One round's fleet draw (all (N,) tensors on the engine's device).

    ``online`` is the availability mask; ``fail_p``/``fail_u`` encode the
    failure decision at any exposure; ``stop_u`` places the interruption
    point within the planned steps; ``bandwidth``/``battery`` feed the
    timing model."""
    online: Any                # (N,) bool
    fail_p: Any                # (N,) float32 — full-exposure failure prob
    fail_u: Any                # (N,) float32 — failure coupling variate
    stop_u: Any                # (N,) float32 — interruption position
    bandwidth: Any             # (N,) float32 — megabits/s this round
    battery: Any               # (N,) float32

    @property
    def fail(self):
        """Failure mask at full exposure (work_frac == 1)."""
        return self.fail_u < self.fail_p

    def failure_mask(self, work_frac):
        """Exposure-scaled failure: P = 1 - (1 - p)^work_frac (§4.2)."""
        w = torch.clamp(work_frac, 0.0, 1.0)
        p = 1.0 - torch.pow(1.0 - self.fail_p, w)
        return self.fail_u < p

    def interruption_step(self, steps):
        """Uniform interruption point within each device's planned
        steps."""
        return torch.floor(self.stop_u * steps.clamp_min(1)).to(torch.int32)

    def download_mask(self, distribute):
        """Downloads that actually happen: §4.4 transmits the fresh model
        only to reachable devices."""
        return distribute & self.online

    def take(self, idx):
        """The draw's rows at the cohort index ``idx`` as an (X,)
        ``FleetDraw``.  Sentinel rows (index N) read benign values:
        offline, failure impossible (p 0 against u 1), interruption at 0,
        unit bandwidth (the timing model never divides by zero), battery
        0 — what the full scan computes for a device never selected."""
        return FleetDraw(online=take_rows(self.online, idx, False),
                         fail_p=take_rows(self.fail_p, idx, 0.0),
                         fail_u=take_rows(self.fail_u, idx, 1.0),
                         stop_u=take_rows(self.stop_u, idx, 0.0),
                         bandwidth=take_rows(self.bandwidth, idx, 1.0),
                         battery=take_rows(self.battery, idx, 0.0))


# ---------------------------------------------------------------------------
# Named uniforms
# ---------------------------------------------------------------------------

class Uniform(NamedTuple):
    """One (N,) float32 uniform a process consumes, on [low, high)."""
    name: str
    low: float = 0.0
    high: float = 1.0


def draw_noise(specs, num_clients: int, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """The uniforms of ``specs`` drawn from ``generator`` on ``device``,
    in order: ``low + (high - low) * U[0, 1)``, floored at ``low``."""
    out = {}
    for s in specs:
        u = torch.rand((num_clients,), generator=generator, device=device)
        if (s.low, s.high) != (0.0, 1.0):
            # the range in float32, as jax.random.uniform forms it
            low = float(np.float32(s.low))
            span = float(np.float32(s.high) - np.float32(s.low))
            u = torch.clamp_min(u * span + low, low)
        out[s.name] = u
    return out


# ---------------------------------------------------------------------------
# Process protocol
# ---------------------------------------------------------------------------

BASE_NOISE = (Uniform("fail"), Uniform("stop"))


class DynamicsProcess:
    """Fleet-dynamics process: static config + pure state transitions.

    ``init_state(noise)`` builds the ``FleetState`` carry; ``step(state,
    noise)`` maps it to ``(state', FleetDraw)``.  ``noise`` is a dict of
    the (N,) uniforms named in ``init_noise`` / ``step_noise``.  Both are
    tensor code with no host read-back, so the engine's round loop never
    waits for the card here.  ``host_side=True`` marks processes whose
    draws come from the host RNG (``bernoulli_host``): the engine runs
    those through the host round loop instead."""
    name = "base"
    host_side = False
    init_noise: Tuple[Uniform, ...] = ()
    step_noise: Tuple[Uniform, ...] = BASE_NOISE

    def __init__(self, sim_cfg, features: Optional[FleetFeatures] = None,
                 fleet=None, device="cpu", **params):
        if features is None:
            if fleet is None:
                raise ValueError(
                    f"dynamics process {self.name!r} needs FleetFeatures "
                    f"(or a Fleet to derive them from)")
            features = FleetFeatures.from_fleet(fleet, device)
        self.sim_cfg = sim_cfg
        self.features = features
        self.params = dict(params)

    @property
    def num_clients(self) -> int:
        return self.features.num_clients

    @property
    def device(self) -> torch.device:
        return self.features.device

    def init_state(self, noise) -> FleetState:
        return FleetState(t=torch.zeros((), dtype=torch.int32,
                                        device=self.device))

    def step(self, state: FleetState, noise) -> Tuple[FleetState, FleetDraw]:
        raise NotImplementedError

    # -- shared draw plumbing ----------------------------------------------
    def _base_draw(self, noise, online, fail_p=None, bandwidth=None,
                   battery=None) -> FleetDraw:
        """Fill the coupling variates (``noise["fail"]``,
        ``noise["stop"]``) and defaults around a process's online mask."""
        f = self.features
        return FleetDraw(
            online=online,
            fail_p=f.undep if fail_p is None else fail_p,
            fail_u=noise["fail"], stop_u=noise["stop"],
            bandwidth=f.bandwidth if bandwidth is None else bandwidth,
            battery=f.battery if battery is None else battery)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[DynamicsProcess]] = {}


def register_dynamics(name: str, *, allow_override: bool = False):
    """Class decorator: ``@register_dynamics("markov")`` makes the process
    constructible by name through ``make_dynamics`` /
    ``FLConfig.dynamics``."""
    def deco(cls: Type[DynamicsProcess]) -> Type[DynamicsProcess]:
        if not (isinstance(cls, type)
                and issubclass(cls, DynamicsProcess)):
            raise TypeError(f"@register_dynamics expects a DynamicsProcess "
                            f"subclass, got {cls!r}")
        if name in _REGISTRY and not allow_override:
            raise ValueError(f"dynamics {name!r} already registered "
                             f"(pass allow_override=True to replace)")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_dynamics(name: str) -> Type[DynamicsProcess]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown dynamics {name!r}; registered: "
                       f"{', '.join(available_dynamics())}") from None


def available_dynamics():
    return sorted(_REGISTRY)


def make_dynamics(name: str, sim_cfg, features=None, fleet=None,
                  device="cpu", params: Tuple = ()) -> DynamicsProcess:
    """Instantiate a registered process.  ``params`` is the
    ``FLConfig.dynamics_params`` tuple of ``(key, value)`` pairs."""
    return get_dynamics(name)(sim_cfg, features=features, fleet=fleet,
                              device=device, **dict(params))


# ---------------------------------------------------------------------------
# Offline simulation helpers (examples / tests / summaries)
# ---------------------------------------------------------------------------

def simulate_availability(process: DynamicsProcess, rounds: int,
                          seed: int = 0) -> np.ndarray:
    """Roll a process forward ``rounds`` rounds on its device, the
    uniforms drawn from a generator seeded with ``seed``; returns the
    (T, N) bool online matrix.  Host-side processes draw from their
    wrapped Fleet's RNG."""
    if process.host_side:
        return np.stack([process.online_mask() for _ in range(rounds)])
    n, device = process.num_clients, process.device
    gen = torch.Generator(device=device).manual_seed(seed)
    state = process.init_state(draw_noise(process.init_noise, n, gen,
                                          device))
    rows = []
    for _ in range(rounds):
        state, draw = process.step(state, draw_noise(process.step_noise, n,
                                                     gen, device))
        rows.append(draw.online)
    return torch.stack(rows).cpu().numpy()


def availability_summary(online: np.ndarray) -> Dict[str, float]:
    """Summary statistics of a (T, N) availability matrix: mean online
    fraction and mean session length (consecutive-online run length, in
    rounds, over sessions that started within the window)."""
    online = np.asarray(online, bool)
    frac = float(online.mean())
    # session starts: online now, offline (or window edge) before
    prev = np.vstack([np.zeros((1, online.shape[1]), bool), online[:-1]])
    starts = online & ~prev
    n_sessions = int(starts.sum())
    mean_len = float(online.sum() / n_sessions) if n_sessions else 0.0
    return {"mean_online_fraction": frac,
            "mean_session_length": mean_len,
            "num_sessions": n_sessions}
