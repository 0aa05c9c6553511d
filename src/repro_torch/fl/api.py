"""Typed policy API for the cross-device FL runner (port of ``repro.fl.api``).

The server policy loop speaks three typed dataclasses:

* ``RoundPlan``        — what the server decides *before* a round (who is
                         selected, who gets a fresh model, who resumes from
                         cache, the receive quorum, optional per-device step
                         counts and aggregation-weight multipliers);
* ``RoundObservation`` — what a policy may look at when planning (round
                         index, online mask, the device-resident caches,
                         the round's explore uniforms);
* ``RoundReport``      — what actually happened (received/fail masks, local
                         losses, per-device finish times, billed duration).

A ``Policy`` holds static configuration; its mutable state is explicit and
threaded through ``plan``/``observe`` so the engine owns the loop.
Policies register by name with ``@register_policy`` and are built with
``make_policy``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.caching import ClientCaches
from repro_torch.fl.simulator import Fleet, SimConfig

_BOOL_FIELDS = ("selected", "distribute", "resume")


def to_host(x) -> np.ndarray:
    """numpy view of a tensor on any device, or of an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_bool_mask(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.bool)
    return np.asarray(x, bool)


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Server-side decisions for one round.

    selected/distribute/resume: (N,) bool masks (tensors or numpy).
    ``quorum`` is the receive cutoff — the round closes after that many
    successful uploads (§4.4 Alg. 2 line 15).  ``steps_override``
    (optional, (N,) int) replaces the uniform ``local_steps`` workload;
    ``agg_weights`` (optional, (N,) float) multiplies the server
    aggregation weights.
    """
    selected: Any
    distribute: Any
    resume: Any
    quorum: Any
    steps_override: Optional[Any] = None
    agg_weights: Optional[Any] = None

    @classmethod
    def create(cls, selected, distribute, resume, quorum,
               steps_override=None, agg_weights=None,
               num_clients: Optional[int] = None) -> "RoundPlan":
        """Canonicalize + validate: coerces mask dtypes to bool and runs
        the full shape/value validation."""
        plan = cls(selected=_as_bool_mask(selected),
                   distribute=_as_bool_mask(distribute),
                   resume=_as_bool_mask(resume),
                   quorum=float(quorum),
                   steps_override=steps_override,
                   agg_weights=agg_weights)
        plan.validate(num_clients)
        object.__setattr__(plan, "_validated", True)
        return plan

    def _check_structure(self, num_clients: Optional[int] = None) -> int:
        """Shape/dtype checks on array metadata."""
        n = num_clients
        for name in _BOOL_FIELDS:
            arr = getattr(self, name)
            if arr is None:
                raise ValueError(f"RoundPlan.{name} is required")
            if getattr(arr, "ndim", None) != 1:
                raise ValueError(f"RoundPlan.{name} must be a 1-D mask, "
                                 f"got shape {getattr(arr, 'shape', None)}")
            if arr.dtype not in (torch.bool, np.bool_):
                raise ValueError(f"RoundPlan.{name} must be bool, got "
                                 f"{arr.dtype}")
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ValueError(
                    f"RoundPlan.{name} has {arr.shape[0]} entries, "
                    f"expected {n}")
        return n

    def validate(self, num_clients: Optional[int] = None,
                 local_steps: Optional[int] = None) -> "RoundPlan":
        """Shape/dtype/value checks; raises ``ValueError`` on malformed
        plans and returns self.  ``local_steps`` (when given) caps
        ``steps_override`` at the trainer's scan length: more work than
        the trainer can run would silently truncate training while the
        timing model charged the full request."""
        n = self._check_structure(num_clients)
        selected = to_host(self.selected)
        n_sel = int(selected.sum())
        q = float(self.quorum)
        if q < 0:
            raise ValueError(f"RoundPlan.quorum must be >= 0, got {q}")
        if q > n_sel:
            raise ValueError(
                f"RoundPlan.quorum ({q}) exceeds the selected count "
                f"({n_sel}) — the round could never close on uploads")
        if n_sel > 0 and q < 1:
            raise ValueError(
                "RoundPlan.quorum must be >= 1 when any device is "
                "selected — a zero quorum idle-waits the full deadline")
        if (to_host(self.resume) & ~selected).any():
            raise ValueError("RoundPlan.resume must be a subset of "
                             "RoundPlan.selected")
        if self.steps_override is not None:
            so = to_host(self.steps_override)
            if so.shape != (n,) or not np.issubdtype(so.dtype, np.integer):
                raise ValueError(
                    f"RoundPlan.steps_override must be (N,) int, got "
                    f"shape {so.shape} dtype {so.dtype}")
            if (so < 0).any():
                raise ValueError("RoundPlan.steps_override must be >= 0")
            if local_steps is not None and so.size \
                    and int(so.max()) > local_steps:
                raise ValueError(
                    f"RoundPlan.steps_override requests up to "
                    f"{int(so.max())} local steps but the trainer scans "
                    f"only {local_steps} — the excess would silently not "
                    f"run while the timing model charged it")
        if self.agg_weights is not None:
            w = to_host(self.agg_weights).astype(np.float32)
            if w.shape != (n,):
                raise ValueError(
                    f"RoundPlan.agg_weights must be (N,), got {w.shape}")
            if not np.isfinite(w).all() or (w < 0).any():
                raise ValueError(
                    "RoundPlan.agg_weights must be finite and >= 0")
        return self


@dataclasses.dataclass(frozen=True)
class RoundReport:
    """What happened in one round, fed back to ``Policy.observe``.

    received: (N,) bool — uploaded before the cutoff.
    fail:     (N,) bool — interrupted mid-round (undependability draw).
    losses:   (N,) float — mean local training loss (garbage for idle).
    durations:(N,) float — per-device finish time, inf if never uploaded.
    duration: float — billed round wall clock (cutoff or deadline).
    rnd:      int — round index.

    On the host-RNG loop the array fields are numpy and ``duration`` is a
    python float.
    """
    received: Any
    fail: Any
    losses: Any
    durations: Any
    duration: float
    rnd: int


@dataclasses.dataclass(frozen=True)
class RoundObservation:
    """What a policy may read when planning round ``rnd``.

    ``online`` is the host (numpy) mask; ``caches`` stay on the engine's
    device.  ``uniforms`` is the round's (N,) float32 explore noise in
    [0, 1), drawn by the engine (the reference draws it from the round's
    ``jax.random`` key inside the selector).
    """
    rnd: int
    online: Any
    caches: ClientCaches
    uniforms: Any = None


class Policy:
    """Server-side policy: static config + state transitions.

    ``init_state`` builds the policy's mutable state; ``plan`` maps
    (state, observation) to (state', RoundPlan); ``observe`` folds a
    RoundReport back into the state.  Subclasses override the three
    methods and the class flags.
    """
    name = "base"
    uses_cache = False            # wants the C3 client cache machinery
    waits_for_stragglers = True   # sync designs idle-wait to the deadline

    def __init__(self, sim_cfg: SimConfig, fl_cfg: FLConfig,
                 fleet: Optional[Fleet] = None, device="cpu"):
        self.sim_cfg = sim_cfg
        self.fl_cfg = fl_cfg
        self.fleet = fleet
        # the engine's device: where policies keep (N,) state
        self.device = torch.device(device)

    def init_state(self) -> Any:
        return None

    def plan(self, state: Any,
             obs: RoundObservation) -> Tuple[Any, RoundPlan]:
        raise NotImplementedError

    def observe(self, state: Any, plan: RoundPlan,
                report: RoundReport) -> Any:
        return state

    def history_extras(self, state: Any) -> Dict[str, Any]:
        """Optional end-of-run diagnostics merged into ``History``."""
        return {}


_REGISTRY: Dict[str, Type[Policy]] = {}


def register_policy(name: str, *, allow_override: bool = False):
    """Class decorator: ``@register_policy("flude")`` makes the policy
    constructible by name through ``make_policy`` / ``FleetEngine.run``."""
    def deco(cls: Type[Policy]) -> Type[Policy]:
        if not (isinstance(cls, type) and issubclass(cls, Policy)):
            raise TypeError(f"@register_policy expects a Policy subclass, "
                            f"got {cls!r}")
        if name in _REGISTRY and not allow_override:
            raise ValueError(f"policy {name!r} already registered "
                             f"(pass allow_override=True to replace)")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_policy(name: str) -> Type[Policy]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; registered: "
                       f"{', '.join(available_policies())}") from None


def available_policies():
    return sorted(_REGISTRY)


def make_policy(name: str, sim_cfg: SimConfig, fl_cfg: FLConfig,
                fleet: Optional[Fleet] = None, device="cpu") -> Policy:
    return get_policy(name)(sim_cfg, fl_cfg, fleet, device=device)
