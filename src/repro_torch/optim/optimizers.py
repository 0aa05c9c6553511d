"""Functional optimizers over the port's parameter tree: SGD, momentum,
Adam(W) and the warmup-cosine schedule.

The port of ``repro.optim.optimizers``, with its arithmetic: moments in
``cfg.moment_dtype``, every update computed in fp32 and cast back, the
bias corrections ``1 - b**count`` in fp32, ``u = m̂ / (√v̂ + eps)`` and
then ``+ wd·p``, and ``p - lr·u``.  ``torch.optim`` is not used: its
AdamW decays the weights before the update and per parameter group.

The tree is the port's: nested dicts whose layered trees (``blocks``,
``mamba``, ``mamba_norm``) are lists of per-layer dicts.  The reference
stacks each of those on a leading layer axis, and AdamW decays a leaf
when its *stacked* rank is at least 2, so a per-layer norm scale of
shape (d,) decays, as the reference's (L, d) leaf does; a leaf inside a
list counts one more axis than it has.

    opt = make_optimizer(train_cfg)
    state = opt.init(params)
    params, state = opt.step(params, grads, state)

Nothing is read back to the host: the step count, the learning rate and
the bias corrections stay 0-dim tensors on the parameters' device, and
the per-leaf passes are ``torch._foreach_*`` calls with the same
per-element arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class OptState(NamedTuple):
    mu: Any            # first moment (or momentum buffer); None for sgd
    nu: Any            # second moment (adam only)
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    step: Callable[..., Any]


def stacked_ranks(tree, extra: int = 0) -> List[int]:
    """Each leaf's rank in the reference's stacked layout, in
    ``tree_leaves`` order: a leaf inside a per-layer list has one axis
    more there (the layer axis)."""
    if isinstance(tree, dict):
        return [r for k in sorted(tree) for r in stacked_ranks(tree[k],
                                                               extra)]
    if isinstance(tree, list):
        return [r for t in tree for r in stacked_ranks(t, 1)]
    return [tree.ndim + extra]


def global_norm(tree) -> torch.Tensor:
    leaves = [l.float() for l in tree_leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  floor_frac: float = 0.1) -> Callable:
    """lr(step) in fp32, ``step`` a number or a 0-dim tensor."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        wu = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = floor_frac + (1 - floor_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return base_lr * wu * cos
    return lr


def make_optimizer(cfg: TrainConfig,
                   lr_fn: Optional[Callable] = None) -> Optimizer:
    if lr_fn is None:
        lr_fn = warmup_cosine(cfg.learning_rate, cfg.warmup_steps,
                              cfg.total_steps)
    kind = cfg.optimizer
    if kind not in ("sgd", "momentum", "adam", "adamw"):
        raise ValueError(f"unknown optimizer {kind!r}")
    mdt = MOMENT_DTYPES[cfg.moment_dtype]

    def zeros(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                              device=p.device), params)

    def init(params):
        count = torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device)
        if kind in ("adam", "adamw"):
            return OptState(zeros(params), zeros(params), count)
        if kind == "momentum":
            return OptState(zeros(params), None, count)
        return OptState(None, None, count)

    def step(params, grads, state: OptState, *, lr_scale=1.0):
        count = state.count + 1
        lr = lr_fn(count) * lr_scale
        if cfg.grad_clip:
            grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        ps = tree_leaves(params)
        g32 = [g.float() for g in tree_leaves(grads)]
        p32 = [p.float() for p in ps]

        def cast_back(new32):
            return tree_unflatten(params, [n.to(p.dtype)
                                           for n, p in zip(new32, ps)])

        if kind in ("adam", "adamw"):
            b1, b2, eps = cfg.beta1, cfg.beta2, 1e-8
            m32 = [m.float() for m in tree_leaves(state.mu)]
            v32 = [v.float() for v in tree_leaves(state.nu)]
            mu = torch._foreach_add(torch._foreach_mul(m32, b1),
                                    torch._foreach_mul(g32, 1 - b1))
            gg = torch._foreach_mul(torch._foreach_mul(g32, 1 - b2), g32)
            nu = torch._foreach_add(torch._foreach_mul(v32, b2), gg)
            mu = [m.to(mdt) for m in mu]
            nu = [v.to(mdt) for v in nu]
            c = count.float()
            bc1 = 1 - b1 ** c
            bc2 = 1 - b2 ** c
            mhat = torch._foreach_div([m.float() for m in mu], bc1)
            vhat = torch._foreach_div([v.float() for v in nu], bc2)
            den = torch._foreach_add(torch._foreach_sqrt(vhat), eps)
            u = torch._foreach_div(mhat, den)
            if kind == "adamw":
                decay = [i for i, r in enumerate(stacked_ranks(params))
                         if r >= 2]
                torch._foreach_add_([u[i] for i in decay],
                                    torch._foreach_mul(
                                        [p32[i] for i in decay],
                                        cfg.weight_decay))
            new = torch._foreach_sub(p32, torch._foreach_mul(u, lr))
            return cast_back(new), OptState(
                tree_unflatten(state.mu, mu), tree_unflatten(state.nu, nu),
                count)

        if kind == "momentum":
            # 0.9·m in the moment dtype, + g in fp32, as the reference
            # (which leaves the buffer fp32 after the first step)
            mu = [m * 0.9 + g for m, g in zip(tree_leaves(state.mu), g32)]
            new = torch._foreach_sub(p32, torch._foreach_mul(mu, lr))
            return cast_back(new), OptState(tree_unflatten(state.mu, mu),
                                            None, count)

        new = torch._foreach_sub(p32, torch._foreach_mul(g32, lr))
        return cast_back(new), OptState(None, None, count)

    return Optimizer(init=init, step=step)
