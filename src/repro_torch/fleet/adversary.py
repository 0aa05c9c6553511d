"""Adversarial fleet models: Byzantine client attacks at a configurable
malicious fraction (a numpy copy of ``repro.fleet.adversary``).

FLUDE's dependability machinery sees *undependable* devices (they fail
to upload); it is blind to *malicious* ones (they upload poison).  An
adversary is static per run: ``malicious_mask(num_clients, seed)``
deterministically marks ``malicious_frac`` of the fleet (an exact count,
from a salted RNG independent of the availability draws, so the mask is
the reference's for the same seed).  Two corruption channels:

* ``flips_labels`` — data poisoning: the marked clients' local labels
  are flipped once at engine construction (``corrupt_data``); their
  *training* is honest on corrupt data.
* ``delta_scale`` — model poisoning: the marked clients' uploads are
  transformed inside the server round step as
  ``u' = g + delta_scale * (u - g)``.  ``delta_scale = -s`` is the
  scaled sign-flip (reverse) attack; ``delta_scale = +s`` the
  gradient-scaling (boosting) attack.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np


class Adversary:
    """Attack model: a deterministic malicious slice + corruption spec."""
    name = "base"
    flips_labels = False
    delta_scale: Optional[float] = None   # u' = g + delta_scale * (u - g)

    def __init__(self, malicious_frac: float = 0.1, **params):
        if not 0.0 <= float(malicious_frac) <= 1.0:
            raise ValueError(f"malicious_frac must be in [0, 1], got "
                             f"{malicious_frac!r}")
        self.malicious_frac = float(malicious_frac)
        self.params = dict(params)

    def malicious_mask(self, num_clients: int, seed: int) -> np.ndarray:
        """(N,) bool — exactly ``round(frac * N)`` marked clients, drawn
        from a salted RNG so the same sim seed compares attack fractions
        on the same fleet."""
        rng = np.random.RandomState((int(seed) + 0xAD5) % (2 ** 31))
        k = int(round(self.malicious_frac * num_clients))
        mask = np.zeros(num_clients, bool)
        mask[rng.permutation(num_clients)[:k]] = True
        return mask

    def corrupt_data(self, data, mask: np.ndarray):
        """Data-poisoning hook; identity unless ``flips_labels``."""
        return data


class _ScaledDeltaAdversary(Adversary):
    """Shared base for model-poisoning attacks parameterized by a scale."""
    _sign = 1.0
    _default_scale = 1.0

    def __init__(self, malicious_frac: float = 0.1,
                 scale: Optional[float] = None):
        super().__init__(malicious_frac)
        s = self._default_scale if scale is None else float(scale)
        if s <= 0:
            raise ValueError(f"scale must be positive, got {scale!r}")
        self.delta_scale = self._sign * s


class SignFlipAdversary(_ScaledDeltaAdversary):
    """Scaled reverse attack: ``u' = g - scale * (u - g)`` — malicious
    updates point *against* the honest descent direction, amplified."""
    _sign = -1.0
    _default_scale = 4.0


class GradScaleAdversary(_ScaledDeltaAdversary):
    """Boosting attack: ``u' = g + scale * (u - g)`` — malicious updates
    overshoot, dragging the mean far past the honest step."""
    _sign = 1.0
    _default_scale = 10.0


class LabelFlipAdversary(Adversary):
    """Data poisoning: malicious clients train honestly on flipped
    labels ``y' = (num_classes - 1) - y``."""
    flips_labels = True

    def corrupt_data(self, data, mask: np.ndarray):
        """``data``: a ``FederatedClassification``; the test set stays
        clean."""
        y = np.array(data.y)
        y[mask] = (data.num_classes - 1) - y[mask]
        return data._replace(y=y)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[Adversary]] = {}


def register_adversary(name: str, *, allow_override: bool = False):
    """Class decorator: ``@register_adversary("backdoor")`` makes the
    attack constructible by name through ``make_adversary`` /
    ``FLConfig.adversary``."""
    def deco(cls: Type[Adversary]) -> Type[Adversary]:
        if not (isinstance(cls, type) and issubclass(cls, Adversary)):
            raise TypeError(f"@register_adversary expects an Adversary "
                            f"subclass, got {cls!r}")
        if name in _REGISTRY and not allow_override:
            raise ValueError(f"adversary {name!r} already registered "
                             f"(pass allow_override=True to replace)")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_adversary(name: str) -> Type[Adversary]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown adversary {name!r}; registered: "
                       f"{', '.join(available_adversaries())}") from None


def available_adversaries():
    return sorted(_REGISTRY)


def make_adversary(name: str, params: Tuple = ()) -> Adversary:
    """Instantiate a registered adversary.  ``params`` is the hashable
    ``FLConfig.adversary_params`` tuple of ``(key, value)`` pairs."""
    return get_adversary(name)(**dict(params))


register_adversary("sign_flip")(SignFlipAdversary)
register_adversary("grad_scale")(GradScaleAdversary)
register_adversary("label_flip")(LabelFlipAdversary)
