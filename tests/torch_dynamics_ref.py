"""The reference's dynamics and explore random numbers, for the port's
parity tests (``test_torch_fleet_dynamics.py``, ``test_torch_device_rounds.py``).

The port's processes take their (N,) uniforms as named inputs; the
reference draws them from ``jax.random`` keys.  ``reference_noise``
walks the reference's key structure — ``dyn_base = fold_in(key(seed),
0x0F1EE7)``, the init key ``fold_in(dyn_base, 1 << 20)``, round ``rnd``'s
key ``fold_in(dyn_base, rnd)`` — and each process's own splits
(``repro/fleet/processes.py``, ``traces.py``, ``api.py`` ``_base_draw``),
and returns the numbers under the port's names.  A wrong split shows up
in the per-process parity test as a wrong online mask.
"""
import jax
import numpy as np

DYN_SALT = 0x0F1EE7
INIT_FOLD = 1 << 20
WEIBULL_LOW = 1e-7


def _u(key, n, low=0.0):
    return np.asarray(jax.random.uniform(key, (n,), minval=low, maxval=1.0))


def _base(key, n):
    """``_base_draw``: ``k_fail, k_stop = split(key)``."""
    k_fail, k_stop = jax.random.split(key)
    return {"fail": _u(k_fail, n), "stop": _u(k_stop, n)}


def _init(process: str, key, n):
    if process == "markov":
        return {"on": _u(key, n)}
    if process == "sessions":
        k_on, k_dur = jax.random.split(key)
        return {"on": _u(k_on, n), "dur_on": _u(k_dur, n, WEIBULL_LOW),
                "dur_gap": _u(jax.random.fold_in(k_dur, 1), n,
                              WEIBULL_LOW)}
    return {}                               # bernoulli, trace


def _step(process: str, key, n):
    if process == "bernoulli":
        k_on, k_draw = jax.random.split(key)
        return {"on": _u(k_on, n), **_base(k_draw, n)}
    if process == "markov":
        k_flip, k_draw = jax.random.split(key)
        return {"flip": _u(k_flip, n), **_base(k_draw, n)}
    if process == "sessions":
        k_on, k_gap, k_draw = jax.random.split(key, 3)
        return {"new_on": _u(k_on, n, WEIBULL_LOW),
                "new_gap": _u(k_gap, n, WEIBULL_LOW), **_base(k_draw, n)}
    if process == "trace":
        return _base(key, n)
    raise KeyError(process)


def reference_noise(process: str, seed: int, rounds: int, n: int):
    """``{"init": {...}, 0: {...}, ...}``: the uniforms the reference's
    engine draws for ``process`` under ``sim_cfg.seed = seed``."""
    dyn_base = jax.random.fold_in(jax.random.key(seed), DYN_SALT)
    out = {"init": _init(process, jax.random.fold_in(dyn_base, INIT_FOLD),
                         n)}
    for rnd in range(rounds):
        out[rnd] = _step(process, jax.random.fold_in(dyn_base, rnd), n)
    return out


def reference_keys(seed: int, rounds: int):
    """The reference engine's keys: the init key and each round's."""
    dyn_base = jax.random.fold_in(jax.random.key(seed), DYN_SALT)
    return (jax.random.fold_in(dyn_base, INIT_FOLD),
            [jax.random.fold_in(dyn_base, r) for r in range(rounds)])


def reference_explore_uniforms(seed: int, rounds: int, n: int):
    """The reference's per-round explore noise: ``rng = key(seed)``, then
    each round ``rng, k = split(rng)`` and ``uniform(k, (N,))``."""
    rng = jax.random.key(seed)
    out = []
    for _ in range(rounds):
        rng, k = jax.random.split(rng)
        out.append(np.asarray(jax.random.uniform(k, (n,))))
    return out
