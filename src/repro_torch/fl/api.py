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
``cohort_index`` / ``cohort_overflow`` turn a plan's selection mask into
the compact-cohort round's (X,) index.
Policies register by name with ``@register_policy`` and are built with
``make_policy``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Type

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


def cohort_index(selected, cohort_size: int) -> torch.Tensor:
    """Cohort index of a selection mask: the ascending ids of the
    selected clients, padded to the static ``cohort_size`` with the
    out-of-range sentinel N (= ``selected.shape[0]``); int64 on the
    mask's device.

    The reference's ``jnp.flatnonzero(sel, size=X, fill_value=N)`` with
    fixed shapes and no read-back: entry k is the first position where
    the running count of selected clients reaches k + 1
    (``searchsorted`` on the cumulative sum), and N where it never
    does.  Past ``cohort_size`` selections the index keeps the lowest
    ids — pair with :func:`cohort_overflow`."""
    sel = torch.as_tensor(selected).to(torch.bool)
    counts = torch.cumsum(sel, 0)
    want = torch.arange(1, cohort_size + 1, dtype=counts.dtype,
                        device=counts.device)
    return torch.searchsorted(counts, want)


def cohort_overflow(selected, cohort_size: int) -> torch.Tensor:
    """0-d bool tensor: did the plan select more clients than the static
    cohort holds (did :func:`cohort_index` truncate)?"""
    return torch.as_tensor(selected).sum() > cohort_size


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

    @classmethod
    def device(cls, selected, distribute, resume, quorum,
               steps_override=None, agg_weights=None) -> "RoundPlan":
        """Construction for policies that plan on the engine's device.

        Runs the structural checks only (1-D bool masks of one length,
        optionals of the same length, a 0-d quorum) — shape and dtype are
        tensor metadata, so nothing is read back and ``quorum`` stays a
        device scalar: the round loop can queue the round without waiting
        for the card.  The value invariants (quorum ≤ |selected|, resume ⊆
        selected) are the caller's: the built-in device policy guarantees
        them by construction, and the engine clamps the workload
        regardless."""
        plan = cls(selected=selected, distribute=distribute, resume=resume,
                   quorum=quorum, steps_override=steps_override,
                   agg_weights=agg_weights)
        n = plan._check_structure()
        if getattr(quorum, "ndim", 0) != 0:
            raise ValueError(
                f"RoundPlan.quorum must be a scalar, got shape "
                f"{getattr(quorum, 'shape', None)}")
        if steps_override is not None and (
                tuple(getattr(steps_override, "shape", ())) != (n,)
                or steps_override.dtype.is_floating_point
                or steps_override.dtype == torch.bool):
            raise ValueError(
                f"RoundPlan.steps_override must be ({n},) int, got shape "
                f"{getattr(steps_override, 'shape', None)} dtype "
                f"{getattr(steps_override, 'dtype', None)}")
        if agg_weights is not None and \
                tuple(getattr(agg_weights, "shape", ())) != (n,):
            raise ValueError(
                f"RoundPlan.agg_weights must be ({n},), got "
                f"{getattr(agg_weights, 'shape', None)}")
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

    def cohort_index(self, cohort_size: int) -> torch.Tensor:
        """This plan's cohort index (module-level :func:`cohort_index`):
        ascending selected ids padded with the sentinel N."""
        return cohort_index(self.selected, cohort_size)


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
    python float.  On the device round loop every field but ``rnd`` is a
    tensor on the engine's device (``duration`` the round cut, a 0-d
    float32 tensor; a round that waited out the deadline carries its
    float32 cast, while History bills the exact configured deadline):
    host-side policies read them back at their own boundary.
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

    ``caches`` stay on the engine's device.  ``uniforms`` is the round's
    (N,) float32 explore noise in [0, 1), drawn by the engine (the
    reference draws it from the round's ``jax.random`` key inside the
    selector).  ``draw`` is the round's ``repro_torch.fleet.FleetDraw``
    when a device dynamics process made it (None on the host-RNG loop).
    On that loop ``online`` is the device mask (``draw.online``) and
    ``uniforms`` a device tensor: a policy that plans on the device reads
    them in place, a host-side policy converts with ``to_host`` at its own
    sync point.  On the host-RNG loop ``online`` is a numpy mask.

    ``thompson`` maps the policy's beliefs ``(alpha, beta)`` to the
    round's (N,) float32 Thompson draws on the engine's device (the
    reference samples them from the round's key inside the selector); a
    policy under ``FLConfig.selection_mode="thompson"`` calls it once a
    round with the beliefs it plans from.
    """
    rnd: int
    online: Any
    caches: ClientCaches
    uniforms: Any = None
    draw: Optional[Any] = None
    thompson: Optional[Callable] = None


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
    # static trait: every plan selects at most FLConfig.clients_per_round
    # clients (flude, random, oort, safa, fedsea); the select-all designs
    # (mifa, asyncfeded) leave it False — their bound is the fleet
    selects_at_most_clients_per_round = False
    # static trait: plans and observes on the engine's device without
    # reading anything back (flude); the host-side baselines read the
    # observation and the report back at their own boundary
    plans_on_device = False

    def __init__(self, sim_cfg: SimConfig, fl_cfg: FLConfig,
                 fleet: Optional[Fleet] = None, device="cpu"):
        self.sim_cfg = sim_cfg
        self.fl_cfg = fl_cfg
        self.fleet = fleet
        # the engine's device: where policies keep (N,) state
        self.device = torch.device(device)

    def init_state(self) -> Any:
        return None

    def selection_bound(self) -> int:
        """Static upper bound on any plan's selected count, which the
        engine checks ``FLConfig.cohort_size`` against before a run."""
        n = self.fl_cfg.num_clients
        if self.selects_at_most_clients_per_round:
            return min(self.fl_cfg.clients_per_round, n)
        return n

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
