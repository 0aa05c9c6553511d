"""Cross-silo FLUDE training step.

The port of ``repro.fl.cross_silo``.  Each FL client is a silo that owns
a contiguous block of the global batch.  FLUDE's per-round decisions
enter the step as a per-silo weight vector:

    w_i = selected_i · dependability-derived weight · staleness discount

A silo with w_i = 0 adds exactly nothing to the gradient, the step's
realisation of "an undependable device never uploads".  If no silo
reports (Σw = 0) the model and the optimizer state pass through
unchanged (the paper's empty-round case), by a ``torch.where`` on the
card: nothing is read back to the host.

Gradients come from autograd through the port's model: on the card the
attention, SSD and WKV6 forwards are the hand-written kernels and their
backwards the hand-written backward kernels (``kernels.flash_attention``,
``kernels.ssm_scan``, ``kernels.rwkv6_scan``), in fp32 and, for the
attention and the SSD, in bf16; a bf16 WKV6 on the card refuses grad
(ROADMAP Queue A #15g step 3).  The reference's
``abstract_train_state`` (shapes for the dry-run) and the sharded step
are not ported (ROADMAP Queue A #16, #17).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer, make_optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def init_train_state(model: Model, gen: torch.Generator, opt: Optimizer,
                     params=None) -> TrainState:
    """Parameters drawn on ``gen``'s device (or ``params``, already there,
    in their place), the optimizer's state and step 0 beside them."""
    if params is None:
        params = model.init(gen)
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32, device=gen.device))


def _gate(keep_new: torch.Tensor, new, old):
    """``new`` where ``keep_new`` (a 0-dim bool on the device), else
    ``old``, leaf by leaf over two trees of one structure (None stays)."""
    if old is None:
        return None
    return tree_map(lambda n, o: torch.where(keep_new, n, o), new, old)


def make_train_step(model: Model, train_cfg: TrainConfig, n_silos: int,
                    exec_cfg: Optional[T.ExecConfig] = None,
                    microbatches: int = 1):
    """Builds train_step(state, batch, silo_weights) -> (state, metrics).

    batch leaves have leading dim B = global batch; silo i owns the
    contiguous block [i·B/n_silos, (i+1)·B/n_silos).  ``silo_weights`` is
    (n_silos,), the FLUDE round plan's per-silo aggregation weights.
    Metrics: ``loss``, the weighted loss (the mean cross entropy of the
    received silos' rows; over microbatches, their mean), and
    ``received_weight``, Σw; both 0-dim tensors on the device."""
    exec_cfg = exec_cfg or T.ExecConfig()
    opt = make_optimizer(train_cfg)
    adt = ACCUM_DTYPES[train_cfg.accum_dtype]

    def weighted_loss(params, batch, silo_weights):
        _, metrics = model.loss(params, batch, exec_cfg, per_example=True)
        ce = metrics["ce_per_example"]                      # (B,)
        per_silo = ce.shape[0] // n_silos
        # silo-major fp32 reduction: each silo's examples first, then the
        # weights (the reference's order, that of its sharded program)
        per = ce.float().reshape(n_silos, per_silo).sum(1)
        w = silo_weights.float()
        denom = torch.clamp(w.sum() * per_silo, min=1e-9).detach()
        return (per * w).sum() / denom + metrics["aux"]

    def loss_and_grads(params, batch, silo_weights):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = weighted_loss(tree_unflatten(params, leaves), batch,
                                 silo_weights)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, list(grads))

    def split(x):
        """(B, ...) -> (mb, B/mb, ...) in silo-major order: each
        microbatch holds per_silo/mb rows of EVERY silo."""
        B = x.shape[0]
        per_silo = B // n_silos
        y = x.reshape((n_silos, microbatches, per_silo // microbatches)
                      + tuple(x.shape[1:]))
        return y.transpose(0, 1).reshape((microbatches, B // microbatches)
                                         + tuple(x.shape[1:]))

    def train_step(state: TrainState, batch, silo_weights):
        if microbatches > 1:
            mb = {k: split(v) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                   device=p.device),
                             state.params)
            loss = 0.0
            for i in range(microbatches):
                l, g = loss_and_grads(state.params,
                                      {k: v[i] for k, v in mb.items()},
                                      silo_weights)
                grads = tree_map(lambda a, b: a + b.to(adt), grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
        else:
            loss, grads = loss_and_grads(state.params, batch, silo_weights)

        new_params, new_opt = opt.step(state.params, grads,
                                       state.opt_state)
        del grads
        # FLUDE empty-round gate: no received silos => model unchanged
        any_received = silo_weights.sum() > 0
        new_params = _gate(any_received, new_params, state.params)
        new_opt = type(new_opt)(*(_gate(any_received, n, o) for n, o in
                                  zip(new_opt, state.opt_state)))
        metrics = {"loss": loss, "received_weight": silo_weights.sum()}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def make_prefill_step(model: Model,
                      exec_cfg: Optional[T.ExecConfig] = None):
    exec_cfg = exec_cfg or T.ExecConfig()

    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.prefill(params, batch, exec_cfg)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, tokens, positions, cache):
        with torch.inference_mode():
            return model.decode_step(params, tokens, positions, cache)

    return decode_step
