"""Robust server aggregation rules — the ``FLConfig.agg_rule`` axis.

Orthogonal to ``agg_impl`` (cuda | torch): a *rule* decides **what**
statistic of the packed (C, D) client buffer becomes the new global
model, an *impl* decides **how** its inner reductions run.  Rules plug in
through a decorator registry::

    @register_agg_rule("my-rule")
    class MyRule(AggRule):
        def reduce(self, buf, gvec, weights, *, impl, ...): ...

and are instantiated by name via ``make_agg_rule`` / ``FLConfig.agg_rule``
with the hashable ``agg_rule_params`` pairs.

Built-ins:

* ``mean`` — the staleness-discounted weighted mean (the default; the
  round step keeps its direct ``fed_aggregate_packed`` call).
* ``geometric_median`` — smoothed Weiszfeld (RFA, arXiv 1912.13445) over
  the packed buffer; tolerates up to half the received weight being
  arbitrarily corrupted.
* ``trimmed_mean`` — coordinate-wise trimmed mean.
* ``trust`` — stateful: a per-client (N,) trust score carried across
  rounds on the engine's device, updated every round from the observed
  update-deviation norms (cf. FedAR, arXiv 2101.03705) and multiplied
  into the aggregation weights.

Interface contract: ``reduce(buf, gvec, weights, ...)`` gets the packed
(C, D) fp32 client rows, the packed (D,) previous global vector and the
*unnormalized* (C,) aggregation weights (zero = not received) and
returns the (D,) aggregated vector; the caller applies the empty-round
gate and unpacks.  Stateful rules implement ``reduce_stateful`` taking
and returning the (C,) state rows.  The client-sharded reductions are
ROADMAP Queue A #17.
"""
from __future__ import annotations

from typing import Dict, Tuple, Type

import numpy as np
import torch

from repro_torch.kernels.fed_agg.ops import fed_agg_packed
from repro_torch.kernels.robust_agg.ops import (geometric_median,
                                                masked_median,
                                                residual_norms, trimmed_mean)

TINY = 1e-30


class AggRule:
    """Robust aggregation rule: static params + a packed reduction.

    ``stateful=True`` rules add a per-client state row threaded through
    rounds by the engine (see ``TrustRule``).
    """
    name = "base"
    stateful = False

    def __init__(self, **params):
        self.params = dict(params)

    def reduce(self, buf, gvec, weights, *, impl="cuda", block_c=8,
               block_d=2048):
        raise NotImplementedError

    # -- stateful extension -------------------------------------------------
    def init_state(self, num_clients: int):
        raise NotImplementedError(f"agg rule {self.name!r} is stateless")

    def reduce_stateful(self, buf, gvec, weights, state, *, impl="cuda",
                        block_c=8, block_d=2048):
        raise NotImplementedError(f"agg rule {self.name!r} is stateless")


class MeanRule(AggRule):
    """The weighted mean — the reduction the round step runs directly
    when ``agg_rule="mean"``; this class serves the registry, tests and
    direct callers."""

    def reduce(self, buf, gvec, weights, *, impl="cuda", block_c=8,
               block_d=2048):
        w = weights.float()
        return fed_agg_packed(buf, w / w.sum().clamp_min(TINY), impl=impl,
                              block_c=block_c, block_d=block_d)


class GeometricMedianRule(AggRule):
    """Smoothed Weiszfeld geometric median (RFA)."""

    def __init__(self, iters: int = 6, eps: float = 1e-6):
        super().__init__(iters=int(iters), eps=float(eps))
        self.iters = int(iters)
        self.eps = float(eps)

    def reduce(self, buf, gvec, weights, *, impl="cuda", block_c=8,
               block_d=2048):
        return geometric_median(buf, weights, iters=self.iters,
                                eps=self.eps, impl=impl, block_c=block_c,
                                block_d=block_d)


class TrimmedMeanRule(AggRule):
    """Coordinate-wise weighted trimmed mean."""

    def __init__(self, trim: float = 0.2):
        super().__init__(trim=float(trim))
        self.trim = float(trim)

    def reduce(self, buf, gvec, weights, *, impl="cuda", block_c=8,
               block_d=2048):
        return trimmed_mean(buf, weights, trim=self.trim)


class TrustRule(AggRule):
    """Trust-weighted mean with trust learned on the engine's device.

    Every round, each received client's deviation norm
    ``dist_c = ||u_c - g||`` is compared against the received-set median
    (a robust scale reference): ``score_c = (ref / max(dist_c, ref))
    ** power`` is 1 for typical updates and falls quadratically for
    outliers.  Trust is an EMA ``t <- (1 - eta) * t + eta * score`` over
    the rounds a client reports, and the aggregation weight becomes
    ``w_c * clip(t_c, floor, 1)`` — persistent outliers fade to the
    ``floor`` weight.
    """
    stateful = True

    def __init__(self, eta: float = 0.3, floor: float = 0.05,
                 power: float = 2.0, init: float = 1.0):
        super().__init__(eta=float(eta), floor=float(floor),
                         power=float(power), init=float(init))
        self.eta = float(eta)
        self.floor = float(floor)
        self.power = float(power)
        self.init = float(init)

    def init_state(self, num_clients: int) -> np.ndarray:
        return np.full((num_clients,), self.init, np.float32)

    def _update(self, dist, weights, state, ref):
        valid = weights > 0
        ref = ref.clamp_min(1e-12)
        score = (ref / torch.maximum(dist, ref)) ** self.power
        return torch.where(valid, (1.0 - self.eta) * state
                           + self.eta * score, state)

    def reduce_stateful(self, buf, gvec, weights, state, *, impl="cuda",
                        block_c=8, block_d=2048):
        w = weights.float()
        dist = residual_norms(buf, gvec, impl=impl)
        ref = masked_median(dist, w > 0)
        new_state = self._update(dist, w, state, ref)
        w_eff = w * new_state.clamp(self.floor, 1.0)
        vec = fed_agg_packed(buf, w_eff / w_eff.sum().clamp_min(TINY),
                             impl=impl, block_c=block_c, block_d=block_d)
        return vec, new_state


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[AggRule]] = {}


def register_agg_rule(name: str, *, allow_override: bool = False):
    """Class decorator: ``@register_agg_rule("huber")`` makes the rule
    constructible by name through ``make_agg_rule`` /
    ``FLConfig.agg_rule``."""
    def deco(cls: Type[AggRule]) -> Type[AggRule]:
        if not (isinstance(cls, type) and issubclass(cls, AggRule)):
            raise TypeError(f"@register_agg_rule expects an AggRule "
                            f"subclass, got {cls!r}")
        if name in _REGISTRY and not allow_override:
            raise ValueError(f"agg rule {name!r} already registered "
                             f"(pass allow_override=True to replace)")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_agg_rule(name: str) -> Type[AggRule]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown agg rule {name!r}; registered: "
                       f"{', '.join(available_agg_rules())}") from None


def available_agg_rules():
    return sorted(_REGISTRY)


def make_agg_rule(name: str, params: Tuple = ()) -> AggRule:
    """Instantiate a registered rule.  ``params`` is the hashable
    ``FLConfig.agg_rule_params`` tuple of ``(key, value)`` pairs."""
    return get_agg_rule(name)(**dict(params))


register_agg_rule("mean")(MeanRule)
register_agg_rule("geometric_median")(GeometricMedianRule)
register_agg_rule("trimmed_mean")(TrimmedMeanRule)
register_agg_rule("trust")(TrustRule)
