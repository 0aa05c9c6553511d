"""Built-in fleet-dynamics processes of the port (``repro.fleet.processes``).

Four availability regimes over the same static population
(``FleetFeatures``), all on the engine's device except the host wrapper:

* ``bernoulli_host`` — the seed simulator's host numpy RNG path
  (``host_side=True``: the engine runs the host round loop);
* ``bernoulli``      — the same memoryless i.i.d. model, drawn on the
  device;
* ``markov``         — two-state on/off churn with per-device transition
  rates whose stationary distribution matches each device's
  ``online_rate`` (availability correlated in time);
* ``sessions``       — semi-Markov Weibull session/gap lengths with a
  diurnal gap modulation; mid-round interruption follows the session
  hazard.

The trace-replay process lives in ``repro_torch.fleet.traces``.  Each
process names the uniforms it consumes (``init_noise`` / ``step_noise``);
the reference draws the same numbers from ``jax.random`` keys split as
commented at each process.

Float order: the reference jits ``step``, and XLA turns a division by a
constant into a multiplication by the float32 reciprocal; the steps here
multiply by that reciprocal (``_recip``) so both round alike.  The
constructors run outside any jit in the reference and divide exactly.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.fleet.api import (BASE_NOISE, DynamicsProcess, FleetState,
                                   Uniform, register_dynamics)

# the reference's Weibull variates are uniform on [1e-7, 1)
WEIBULL_LOW = 1e-7


def _recip(c: float) -> float:
    """The float32 reciprocal of a constant divisor (XLA's rewrite)."""
    return float(np.float32(1.0) / np.float32(c))


@register_dynamics("bernoulli_host")
class BernoulliHostProcess(DynamicsProcess):
    """Host RNG draws (the seed ``Fleet`` methods), unchanged.

    Exists so the registry covers the historical path; the engine detects
    ``host_side`` and runs the numpy round loop against the wrapped
    ``Fleet``."""
    host_side = True

    def __init__(self, sim_cfg, features=None, fleet=None, device="cpu",
                 **params):
        if fleet is None:
            raise ValueError("bernoulli_host wraps the host Fleet — "
                             "pass fleet=")
        self.sim_cfg = sim_cfg
        self.fleet = fleet
        self.params = dict(params)

    def online_mask(self):
        return self.fleet.online_mask()

    def failure_draw(self, work_frac):
        return self.fleet.failure_draw(work_frac)

    def failure_step(self, steps):
        return self.fleet.failure_step(steps)


@register_dynamics("bernoulli")
class BernoulliProcess(DynamicsProcess):
    """Memoryless i.i.d. availability, drawn on the device: online ~
    Bern(online_rate), exposure-scaled failures from ``undep``.

    Reference keys: ``k_on, k_draw = split(key)``; ``on`` from ``k_on``,
    ``fail, stop = split(k_draw)``."""
    step_noise = (Uniform("on"),) + BASE_NOISE

    def step(self, state, noise):
        online = noise["on"] < self.features.online_rate
        return FleetState(t=state.t + 1, slot=state.slot), \
            self._base_draw(noise, online)


@register_dynamics("markov")
class MarkovProcess(DynamicsProcess):
    """Two-state on/off churn chain, per-device rates.

    ``mean_on`` (rounds) sets the expected on-sojourn: the off→on rate is
    solved so each device's stationary availability equals its
    ``online_rate`` (clipped where the rates would leave [0, 1]).

    Reference keys: ``on`` at init from the init key; per step
    ``k_flip, k_draw = split(key)``."""
    init_noise = (Uniform("on"),)
    step_noise = (Uniform("flip"),) + BASE_NOISE

    def __init__(self, sim_cfg, features=None, fleet=None, device="cpu",
                 mean_on: float = 5.0, **params):
        super().__init__(sim_cfg, features=features, fleet=fleet,
                         device=device, mean_on=mean_on, **params)
        self.mean_on = float(mean_on)
        r = self.features.online_rate
        self._p_on_off = torch.full((), min(max(1.0 / self.mean_on, 0.0),
                                            1.0), device=self.device)
        self._p_off_on = torch.clamp(self._p_on_off * r / (1.0 - r), 0.0,
                                     1.0)

    def stationary(self) -> np.ndarray:
        """Analytic stationary P(online) per device (after clipping)."""
        p10 = np.broadcast_to(self._p_on_off.cpu().numpy(),
                              (self.num_clients,))
        p01 = self._p_off_on.cpu().numpy()
        return p01 / (p01 + p10)

    def init_state(self, noise):
        on0 = noise["on"] < self.features.online_rate
        return FleetState(t=torch.zeros((), dtype=torch.int32,
                                        device=self.device), slot=on0)

    def step(self, state, noise):
        u = noise["flip"]
        on = torch.where(state.slot, u >= self._p_on_off,
                         u < self._p_off_on)
        return FleetState(t=state.t + 1, slot=on), \
            self._base_draw(noise, on)


def _weibull(u, scale, k: float):
    """Weibull(scale, k) via inverse CDF of ``u`` on [1e-7, 1):
    scale * (-ln(1-U))^{1/k}."""
    return scale * torch.pow(-torch.log1p(-u), 1.0 / k)


@register_dynamics("sessions")
class SessionsProcess(DynamicsProcess):
    """Semi-Markov session/gap process with diurnal modulation.

    Devices alternate between online sessions and offline gaps whose
    lengths (in rounds) are Weibull-distributed (``shape_on`` /
    ``shape_gap`` < 1: heavy tails); per-device gap means are solved so
    long-run availability matches ``online_rate``.  Gap draws are scaled
    by ``1 + amp*cos(2π(t-phase)/period)``.  ``fail_p`` is the session
    hazard ``1 - S(a+1)/S(a)`` at the session's age ``a``, optionally
    mixed with the device's ``undep`` (``undep_mix``).

    Reference keys: at init ``k_on, k_dur = split(key)``, ``dur_on`` from
    ``k_dur`` and ``dur_gap`` from ``fold_in(k_dur, 1)``; per step
    ``k_on, k_gap, k_draw = split(key, 3)``."""
    init_noise = (Uniform("on"), Uniform("dur_on", WEIBULL_LOW),
                  Uniform("dur_gap", WEIBULL_LOW))
    step_noise = (Uniform("new_on", WEIBULL_LOW),
                  Uniform("new_gap", WEIBULL_LOW)) + BASE_NOISE

    def __init__(self, sim_cfg, features=None, fleet=None, device="cpu",
                 mean_on: float = 4.0, shape_on: float = 1.0,
                 shape_gap: float = 1.0, amp: float = 0.0,
                 period: float = 24.0, phase: float = 0.0,
                 undep_mix: float = 0.0, **params):
        super().__init__(sim_cfg, features=features, fleet=fleet,
                         device=device, mean_on=mean_on, shape_on=shape_on,
                         shape_gap=shape_gap, amp=amp, period=period,
                         phase=phase, undep_mix=undep_mix, **params)
        self.mean_on = float(mean_on)
        self.shape_on = float(shape_on)
        self.shape_gap = float(shape_gap)
        self.amp = float(amp)
        self.period = float(period)
        self.phase = float(phase)
        self.undep_mix = float(undep_mix)
        r = self.features.online_rate
        mean_gap = self.mean_on * (1.0 - r) / r
        # Weibull scale from mean: λ = mean / Γ(1 + 1/k)
        self._scale_on = self.mean_on / math.gamma(1.0 + 1.0 / self.shape_on)
        self._scale_gap = mean_gap / torch.full_like(
            mean_gap, math.gamma(1.0 + 1.0 / self.shape_gap))

    def _diurnal(self, t):
        x = (t - self.phase) * (2.0 * math.pi) * _recip(self.period)
        return 1.0 + self.amp * torch.cos(x)

    def session_hazard(self, age):
        """P(session ends within one more round | survived to ``age``)."""
        inv = _recip(self._scale_on)
        k = self.shape_on
        return 1.0 - torch.exp(torch.pow(age * inv, k)
                               - torch.pow((age + 1.0) * inv, k))

    def init_state(self, noise):
        on0 = noise["on"] < self.features.online_rate
        dur_on = _weibull(noise["dur_on"], self._scale_on, self.shape_on)
        dur_gap = _weibull(noise["dur_gap"], self._scale_gap,
                           self.shape_gap)
        slot = {"on": on0, "remaining": torch.where(on0, dur_on, dur_gap),
                "age": torch.zeros_like(dur_on)}
        return FleetState(t=torch.zeros((), dtype=torch.int32,
                                        device=self.device), slot=slot)

    def step(self, state, noise):
        slot = state.slot
        remaining = slot["remaining"] - 1.0
        expired = remaining <= 0.0
        on = torch.where(expired, ~slot["on"], slot["on"])
        new_on = _weibull(noise["new_on"], self._scale_on, self.shape_on)
        new_gap = _weibull(noise["new_gap"],
                           self._scale_gap * self._diurnal(state.t),
                           self.shape_gap)
        remaining = torch.where(expired, torch.where(on, new_on, new_gap),
                                remaining)
        age = torch.where(expired, 0.0, slot["age"] + 1.0)
        p_sess = self.session_hazard(age)
        fail_p = 1.0 - (1.0 - p_sess) \
            * (1.0 - self.undep_mix * self.features.undep)
        new_slot = {"on": on, "remaining": remaining, "age": age}
        return FleetState(t=state.t + 1, slot=new_slot), \
            self._base_draw(noise, on, fail_p=fail_p)
