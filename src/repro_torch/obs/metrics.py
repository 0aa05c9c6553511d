"""Device metrics registry: per-round values computed on the round's
device tensors.

Each ``@register_metric`` entry is a plain function of the round's
context (plan masks, receive mask, losses, finish times, cache metadata,
the stacked trainer output and the pre-step global model) returning
0-d tensors or small fixed-size vectors on the engine's device.
``make_metrics_fn`` picks the metrics whose needs the engine's round path
supplies at the configured level and runs them as one Python function.
The engine appends the values to the round ledger's float64 row, so they
ride its existing read-back: telemetry adds no wait for the card.  With
``FLConfig.telemetry=None`` the factory is never called and the round
path runs exactly the ops of an uninstrumented engine.

Context keys (the engine supplies the subset its path produces; every
per-client tensor is the (N,) fleet view, ``rows``/``rows_mask`` the
stacked trainer rows — (N, ...) on the full scan, (X, ...) on a cohort):

``selected, distribute, resume, online, received, fail`` — (N,) bool
masks; ``losses`` — (N,) mean local loss; ``times`` — (N,) finish times
(inf = no upload); ``progress, stamp`` — (N,) C3 cache metadata before
the server step (after the plan-side expiry); ``stamp_pre_expire`` —
(N,) stamps before the discard expiry (discard runs only);
``rule_state`` — (N,) robust-aggregation state (stateful rules);
``rows, rows_mask, global`` — stacked client params, their receive mask
and the pre-step global model; ``rnd`` — the round index.

Static keys (``make_metrics_fn(static=...)``): ``num_clients``,
``cohort_size`` (None on the full scan), ``local_steps``,
``staleness_edges``, and optionally ``rows_bound`` (the round's static
selection bound: ``update_norm`` gathers the received rows into a
(rows_bound, D) block first when the rows are fleet-sized),
``agg_impl`` (the ``fed_agg`` / ``residual_norms`` backend, "cuda" by
default: the kernels on a CUDA tensor, the plain versions on the CPU) and
``pack_layout`` (the model's ``core.aggregation.PackLayout``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.core import aggregation as AGG
from repro_torch.core.caching import take_rows
from repro_torch.kernels.fed_agg.ops import fed_agg_packed
from repro_torch.kernels.robust_agg.ops import residual_norms
from repro_torch.tree import tree_leaves, tree_map

LEVELS = ("basic", "full")
_RANK = {lvl: i for i, lvl in enumerate(LEVELS)}

# default staleness-histogram bucket edges (rounds since cache write);
# bucket b counts edges[b] <= staleness < edges[b+1], last bucket open
STALENESS_EDGES = (0, 1, 2, 4, 8, 16)
# trust_quantiles' quartiles
QUARTILES = (0.25, 0.5, 0.75)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    name: str
    level: str
    needs: Tuple[str, ...]           # ctx keys (+ static availability
    fn: Callable                     # flags like "cohort_size")


_REGISTRY: Dict[str, MetricSpec] = {}


def register_metric(name: str, *, level: str = "basic",
                    needs: Sequence[str] = (),
                    allow_override: bool = False):
    """Register ``fn(ctx, static) -> {column: device scalar/vector}``.

    ``level`` gates when the metric runs (``"basic"`` at both levels,
    ``"full"`` only at full); ``needs`` lists the context keys it reads
    — the engine's round path says what it supplies, and a metric with
    unmet needs is skipped."""
    if level not in LEVELS:
        raise ValueError(f"metric level must be one of {LEVELS}, got "
                         f"{level!r}")

    def deco(fn):
        if name in _REGISTRY and not allow_override:
            raise ValueError(f"metric {name!r} already registered")
        _REGISTRY[name] = MetricSpec(name, level, tuple(needs), fn)
        return fn

    return deco


def available_metrics():
    return sorted(_REGISTRY)


def metrics_for(level: str, available) -> Tuple[MetricSpec, ...]:
    """Registered metrics active at ``level`` whose needs ``available``
    (a set of ctx keys and static availability flags) meets."""
    if level not in LEVELS:
        raise ValueError(f"telemetry level must be one of {LEVELS}, got "
                         f"{level!r}")
    avail = set(available)
    return tuple(s for _, s in sorted(_REGISTRY.items())
                 if _RANK[s.level] <= _RANK[level]
                 and set(s.needs) <= avail)


def make_metrics_fn(level: str, available, static: dict):
    """The active metrics as one function.

    Returns ``(fn, needed)``: ``fn(ctx) -> {column: device value}`` and
    the ctx keys the engine must supply (the union of the metrics'
    needs, static flags left out); ``(None, ())`` when no metric
    applies."""
    specs = metrics_for(level, available)
    if not specs:
        return None, ()
    needed = tuple(sorted({k for s in specs for k in s.needs
                           if k not in static}))

    def metrics_fn(ctx):
        out = {}
        for spec in specs:
            vals = spec.fn(ctx, static)
            dup = set(vals) & set(out)
            if dup:
                raise ValueError(f"metric {spec.name!r} re-emits "
                                 f"columns {sorted(dup)}")
            out.update(vals)
        return out

    return metrics_fn, needed


# ---------------------------------------------------------------------------
# Masked reductions (the reference's definitions)
# ---------------------------------------------------------------------------

def _count(mask):
    return mask.sum(dtype=torch.int32)


def _masked_mean_max(values, mask):
    """Mean / max of ``values`` over ``mask`` rows (0.0 when empty): the
    max is taken over ``where(mask, values, 0)``, as in the reference."""
    n = mask.to(values.dtype).sum()
    got = torch.where(mask, values, 0.0)
    return got.sum() / n.clamp_min(1.0), got.max()


# ---------------------------------------------------------------------------
# Built-in metrics
# ---------------------------------------------------------------------------

@register_metric("counts", needs=("selected", "received", "fail",
                                  "online", "distribute"))
def _counts(ctx, static):
    """Fleet participation counters (Alg. 2 accounting)."""
    return {
        "selected_count": _count(ctx["selected"]),
        "received_count": _count(ctx["received"]),
        "interrupted_count": _count(ctx["fail"]),
        "online_count": _count(ctx["online"]),
        "download_count": _count(ctx["distribute"] & ctx["online"]),
    }


@register_metric("local_loss", needs=("losses", "received"))
def _local_loss(ctx, static):
    """Mean / max local training loss over the uploads the server saw."""
    mean, mx = _masked_mean_max(ctx["losses"], ctx["received"])
    return {"local_loss_mean": mean, "local_loss_max": mx}


@register_metric("round_time", needs=("times", "received"))
def _round_time(ctx, static):
    """Mean / max finish time of the received uploads."""
    mean, mx = _masked_mean_max(ctx["times"], ctx["received"])
    return {"finish_time_mean": mean, "finish_time_max": mx}


@register_metric("cache", needs=("stamp", "resume", "selected"))
def _cache(ctx, static):
    """C3 cache residency and hits (selections resumed from cache)."""
    return {
        "cache_rows": _count(ctx["stamp"] >= 0),
        "cache_hit_count": _count(ctx["resume"] & ctx["selected"]),
    }


@register_metric("cohort_fill", needs=("selected", "cohort_size"))
def _cohort_fill(ctx, static):
    """Share of the static (X,) cohort block the round used."""
    x = static["cohort_size"]
    return {"cohort_fill": _count(ctx["selected"]) / float(x)}


@register_metric("cache_expired", level="full",
                 needs=("stamp", "stamp_pre_expire"))
def _cache_expired(ctx, static):
    """Rows the discard bound pruned this round."""
    dead = (ctx["stamp_pre_expire"] >= 0) & (ctx["stamp"] < 0)
    return {"cache_expired_count": _count(dead)}


@register_metric("staleness_hist", level="full", needs=("stamp", "rnd"))
def _staleness_hist(ctx, static):
    """Histogram of live cache-row staleness (rounds since write)."""
    edges = static["staleness_edges"]
    stamp = ctx["stamp"]
    live = stamp >= 0
    s = ctx["rnd"] - stamp
    buckets = []
    for b, lo in enumerate(edges):
        hi = edges[b + 1] if b + 1 < len(edges) else None
        m = live & (s >= lo)
        if hi is not None:
            m = m & (s < hi)
        buckets.append(_count(m))
    return {"staleness_hist": torch.stack(buckets)}


@register_metric("trust_quantiles", level="full", needs=("rule_state",))
def _trust_quantiles(ctx, static):
    """Quartiles and extremes of the robust rule's per-client trust.

    Linear interpolation between order statistics, as ``jnp.quantile``
    does; the positions depend on N alone, so they are host numbers and
    nothing is read back."""
    state = ctx["rule_state"].to(torch.float32)
    order = torch.sort(state).values
    n = state.shape[0]
    qs = []
    for q in QUARTILES:
        pos = q * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        qs.append(order[lo] + (order[hi] - order[lo]) * frac)
    return {"trust_quartiles": torch.stack(qs),
            "trust_min": order[0], "trust_max": order[-1]}


@register_metric("update_norm", level="full",
                 needs=("rows", "rows_mask", "global"))
def _update_norm(ctx, static):
    """Per-upload update norms ||row_c - global|| and their residual
    around the received mean ||row_c - (global + mean delta)||: the
    dispersion the robust rules act on.

    It runs on the port's two FL kernels.  When ``rows_bound`` is below
    the rows' leading dim (the fleet-sized full scan) the received rows
    are first gathered into a (rows_bound, ...) block by ``cohort_index``
    and ``take_rows``, the reference's compact gather.  The block is
    packed to (K, D); ``residual_norms(block, global)`` gives the norms,
    ``fed_agg(block, mask / cnt)`` the received mean (= global + mean
    delta) and ``residual_norms(block, mean)`` the residuals.  The
    reference expands ||d - m||² = ||d||² - 2⟨d, m⟩ + ||m||²; this is the
    same quantity computed directly."""
    # imported here: repro_torch.fl imports the engine, which imports obs
    from repro_torch.fl.api import cohort_index
    rows, mask = ctx["rows"], ctx["rows_mask"]
    g = ctx["global"]
    impl = static.get("agg_impl", "cuda")
    layout = static.get("pack_layout") or AGG.pack_layout(g)
    lead = tree_leaves(rows)[0].shape[0]
    bound = static.get("rows_bound")
    if bound is not None and bound < lead:
        idx = cohort_index(mask, bound)
        rows = tree_map(lambda r: take_rows(r, idx, 0.0), rows)
        mask = idx < lead
    block = AGG.pack_stacked(rows, layout).contiguous()
    cnt = mask.to(torch.float32).sum().clamp_min(1.0)
    norms = residual_norms(block, AGG.pack(g, layout), impl=impl)
    mean = fed_agg_packed(block, mask.to(torch.float32) / cnt, impl=impl)
    resid = residual_norms(block, mean, impl=impl)
    n_mean, n_max = _masked_mean_max(norms, mask)
    r_mean, r_max = _masked_mean_max(resid, mask)
    return {"update_norm_mean": n_mean, "update_norm_max": n_max,
            "agg_residual_mean": r_mean, "agg_residual_max": r_max}
