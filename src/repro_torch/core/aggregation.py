"""Server-side model aggregation (FedAvg-compatible, masked + weighted).

The received-set mask realizes FLUDE's semantics: devices that became
undependable contribute *zero* (they never uploaded).  Staleness
discounting down-weights updates that started from stale cached models.

The *packed* path (``pack_layout`` / ``fed_aggregate_packed``) flattens the
whole stacked client model into one (C, D) fp32 buffer so the entire model
aggregates in a single ``fed_agg`` call — on a CUDA tensor one launch of
the hand-written kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.kernels.fed_agg.ops import fed_agg_packed
from repro_torch.tree import tree_leaves, tree_map


def aggregation_weights(received: torch.Tensor,
                        n_samples: Optional[torch.Tensor] = None,
                        staleness: Optional[torch.Tensor] = None,
                        staleness_discount: float = 0.0) -> torch.Tensor:
    """Per-client aggregation weights.

    received: (N,) bool — uploaded this round.
    n_samples: (N,) — local dataset sizes (FedAvg weighting).
    staleness: (N,) — rounds of staleness of the base model trained from.
    """
    w = received.to(torch.float32)
    if n_samples is not None:
        w = w * n_samples.to(torch.float32)
    if staleness is not None and staleness_discount > 0.0:
        w = w * torch.pow(1.0 + staleness.clamp_min(0.0),
                          -staleness_discount)
    return w


@dataclasses.dataclass(frozen=True)
class PackLayout:
    """Static layout for flattening a nested-dict model to one row.

    Built once from an *unstacked* template (the global model); leaves are
    packed in sorted key order, the reference's tree order.  The packed
    buffer is always fp32; leaves cast back to their dtype on unpack."""
    keys: Tuple[Tuple[str, ...], ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[Any, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    dim: int                     # D — total packed element count


def _paths(tree, prefix=()):
    """Key paths of a nested dict's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                       prefix + (k,))]
    return [prefix]


def pack_layout(template_params) -> PackLayout:
    keys = tuple(_paths(template_params))
    leaves = tree_leaves(template_params)
    shapes = tuple(tuple(l.shape) for l in leaves)
    sizes = tuple(int(l.numel()) for l in leaves)
    offsets, off = [], 0
    for n in sizes:
        offsets.append(off)
        off += n
    return PackLayout(keys, shapes, tuple(l.dtype for l in leaves), sizes,
                      tuple(offsets), off)


def _check_layout(tree, layout: PackLayout, lead: int) -> list:
    """Leaves in layout order, with structure/shape validated — a mismatched
    tree would otherwise pack into wrong offsets and corrupt silently."""
    if tuple(_paths(tree)) != layout.keys:
        raise ValueError(f"model structure does not match pack layout: "
                         f"{_paths(tree)} vs {list(layout.keys)}")
    leaves = tree_leaves(tree)
    for l, shape in zip(leaves, layout.shapes):
        if tuple(l.shape[lead:]) != shape:
            raise ValueError(f"leaf shape {tuple(l.shape)} does not match "
                             f"layout entry {shape}")
    return leaves


def pack(params, layout: PackLayout) -> torch.Tensor:
    """Unstacked model -> (D,) fp32 vector."""
    leaves = _check_layout(params, layout, lead=0)
    return torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])


def pack_stacked(client_params, layout: PackLayout) -> torch.Tensor:
    """Stacked model (leaves (C, ...)) -> (C, D) fp32 buffer."""
    leaves = _check_layout(client_params, layout, lead=1)
    C = leaves[0].shape[0]
    return torch.cat([l.reshape(C, -1).to(torch.float32) for l in leaves],
                     dim=1)


def unpack(vec: torch.Tensor, layout: PackLayout):
    """(D,) vector -> nested dict with the template's shapes and dtypes."""
    out: dict = {}
    for path, off, n, shape, dt in zip(layout.keys, layout.offsets,
                                       layout.sizes, layout.shapes,
                                       layout.dtypes):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = vec[off:off + n].reshape(shape).to(dt)
    return out


def fed_aggregate_packed(global_params, client_params, weights: torch.Tensor,
                         layout: Optional[PackLayout] = None, *,
                         impl: str = "cuda", block_c: int = 8,
                         block_d: int = 2048):
    """Weighted average over the whole model in ONE aggregation call.

    Weights are normalized by their sum (floored at 1e-30), and when
    nobody reported (Σw == 0) the previous global model passes through
    unchanged.  impl: "cuda" (the Hopper kernel on a CUDA buffer) or
    "torch" (the plain version)."""
    if layout is None:
        layout = pack_layout(global_params)
    buf = pack_stacked(client_params, layout)                # (C, D) fp32
    total = weights.sum().clamp_min(1e-30)
    w_norm = (weights / total).to(torch.float32)
    agg = fed_agg_packed(buf, w_norm, impl=impl, block_c=block_c,
                         block_d=block_d)
    any_received = weights.sum() > 0
    return tree_map(lambda avg, g: torch.where(any_received, avg, g),
                    unpack(agg, layout), global_params)

