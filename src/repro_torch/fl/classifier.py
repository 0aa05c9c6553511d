"""Small tanh-MLP classifier for cross-device FL simulation.

The port of ``repro.fl.classifier``.  Parameters are plain dicts of
tensors with the reference's keys (``{"h0": {"w", "b"}, ..., "out": ...}``).
Every function takes either one model (``w`` (d_in, d_out), ``x`` (..., B,
d)) or a stack of per-client models (``w`` (N, d_in, d_out), ``x`` (N, B,
d)), which the trainer uses in place of ``vmap``.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import ParamSpec, init_params


def classifier_spec(dim: int = 32, hidden: int = 128,
                    num_classes: int = 10, depth: int = 2):
    spec = {}
    d_in = dim
    for i in range(depth):
        spec[f"h{i}"] = {"w": ParamSpec((d_in, hidden), "normal"),
                         "b": ParamSpec((hidden,), "zeros")}
        d_in = hidden
    spec["out"] = {"w": ParamSpec((d_in, num_classes), "normal"),
                   "b": ParamSpec((num_classes,), "zeros")}
    return spec


def init_classifier(gen: torch.Generator, device="cpu", **kw):
    return init_params(classifier_spec(**kw), gen, device)


def _affine(h, layer):
    w, b = layer["w"], layer["b"]
    if w.ndim == 3:                       # a stack of per-client models
        return torch.bmm(h, w) + b[:, None, :]
    return h @ w + b


def clf_logits(params, x):
    h = x
    i = 0
    while f"h{i}" in params:
        h = torch.tanh(_affine(h, params[f"h{i}"]))
        i += 1
    return _affine(h, params["out"])


def clf_loss(params, x, y):
    """Mean cross-entropy over the batch axis (the last axis of ``y``):
    a scalar for one model, (N,) for a stack."""
    lp = torch.log_softmax(clf_logits(params, x), dim=-1)
    return -lp.gather(-1, y.long().unsqueeze(-1)).squeeze(-1).mean(-1)


def clf_accuracy(params, x, y):
    return (clf_logits(params, x).argmax(-1) == y).to(torch.float32).mean(-1)


def clf_per_class_accuracy(params, x, y, num_classes: int):
    pred = clf_logits(params, x).argmax(-1)
    acc = []
    for c in range(num_classes):
        m = y == c
        n = m.sum()
        acc.append(torch.where(n > 0, ((pred == y) & m).sum() / n.clamp_min(1),
                               0.0))
    return torch.stack(acc)
