"""FLUDE cross-silo LM training driver.

The port of ``repro.launch.train``.  Runs real federated rounds: each
round the FLUDE server (Algorithms 1–2) selects silos, the fleet
simulator draws failures, and the cross-silo step trains the causal LM
with the resulting per-silo weights.  Silo sample offsets realise
cache-resume at the data level.

Usage (on the card; ``--device cpu`` for the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch flude-paper \\
      --rounds 200 --silos 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch flude-paper \\
      --scale 100m --rounds 300        # ~100M-parameter end-to-end driver

The explore uniforms of each round's selection come from a
``torch.Generator`` on the device seeded ``seed + 1`` (the reference
splits ``key(seed + 1)``: the two give other numbers, so a parity test
hands the reference's in through ``explore_uniforms``).  On the card the
attention, the SSD scan (zamba2) and the WKV6 scan (rwkv6) run their
hand-written kernels forward and backward (fp32: every ``--scale``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --scale 100m
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --scale 100m
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import save
from repro_torch.configs import SCALES, scaled_config  # noqa: F401
from repro_torch.configs.base import FLConfig, TrainConfig
from repro_torch.convert import lm_params_to_jax
from repro_torch.core.aggregation import aggregation_weights
from repro_torch.core.caching import init_caches
from repro_torch.core.round import init_state, plan_round, \
    update_after_round
from repro_torch.data.synthetic import lm_dataset
from repro_torch.device import resolve_device
from repro_torch.fl import cross_silo
from repro_torch.fl.simulator import Fleet, SimConfig
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="flude-paper")
    ap.add_argument("--scale", default=None, choices=[None, *SCALES])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--silos", type=int, default=8)
    ap.add_argument("--batch-per-silo", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--undep", type=float, default=0.4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, *, params=None,
         explore_uniforms: Optional[Callable[[int], torch.Tensor]] = None,
         progress: Optional[Callable[[int, dict], None]] = None):
    """Run the driver; returns (TrainState, log), ``log`` one dict a round:
    ``loss`` (the step's weighted loss), ``selected`` and ``received``
    (silo counts), ``epsilon`` after the round, and ``t``, the host clock
    when the round's plan was read back (which waits for the previous
    round's step), for ms/round.

    ``params``: initial parameters in the port's layout (a test hands the
    reference's over); default, drawn from ``--seed`` on the device.
    ``explore_uniforms``: ``rnd -> (silos,)`` explore noise in [0, 1) in
    place of the driver's generator.  ``progress(rnd, record)`` is called
    once a round, after its step is issued (a profiler's step)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = scaled_config(args.arch, args.scale)
    model = build_model(cfg)
    print(f"arch={cfg.name} params={model.param_count() / 1e6:.1f}M "
          f"silos={args.silos} device={device}")

    n = args.silos
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=20,
                     total_steps=args.rounds)
    opt = make_optimizer(tc)
    state = cross_silo.init_train_state(
        model, torch.Generator(device=device).manual_seed(args.seed), opt,
        params=params)
    step = cross_silo.make_train_step(model, tc, n)

    # federated data: one shard per silo
    data = lm_dataset(n, vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      n_seq=64, seed=args.seed)
    tokens = torch.from_numpy(data.tokens).to(device)   # (n, n_seq, S+1)
    n_seq = tokens.shape[1]

    # FLUDE server state over silos + fleet simulator
    fl_cfg = FLConfig(num_clients=n, clients_per_round=max(n // 2, 2),
                      local_steps=1)
    sim = SimConfig(num_clients=n, seed=args.seed,
                    undep_means=(args.undep,) * 3)
    fleet = Fleet(sim)
    fstate = init_state(fl_cfg, device)
    caches = init_caches({"offset": torch.zeros((), device=device)}, n)

    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    offsets = np.zeros(n, np.int64)             # data-level cache resume
    bps = args.batch_per_silo
    silo_rows = np.repeat(np.arange(n), bps)
    log = []
    t0 = time.time()
    for rnd in range(args.rounds):
        u = explore_uniforms(rnd) if explore_uniforms is not None else \
            torch.rand((n,), generator=gen, device=device)
        online = fleet.online_mask()
        plan = plan_round(fstate, caches,
                          torch.from_numpy(online).to(device), fl_cfg,
                          u.to(device))
        selected = plan.selected.cpu().numpy()
        t_plan = time.perf_counter()
        fail = fleet.failure_draw(np.where(selected, 1.0, 0.0)) & selected
        received = selected & ~fail

        # per-silo batch from each silo's shard (resume offsets)
        idx = (offsets[:, None] + np.arange(bps)[None]) % n_seq
        offsets += np.where(received, bps, 0)
        bt = tokens[torch.from_numpy(silo_rows).to(device),
                    torch.from_numpy(idx.reshape(-1)).to(device)]
        batch = {"tokens": bt[:, :-1], "labels": bt[:, 1:]}

        received_t = torch.from_numpy(received).to(device)
        w = aggregation_weights(received_t)
        state, metrics = step(state, batch, w.float())
        fstate = update_after_round(fstate, plan, received_t, fl_cfg)
        log.append({"loss": metrics["loss"], "selected": int(selected.sum()),
                    "received": int(received.sum()),
                    "epsilon": fstate.epsilon, "t": t_plan})
        if progress is not None:
            progress(rnd, log[-1])
        if rnd % args.log_every == 0 or rnd == args.rounds - 1:
            print(f"round {rnd:4d} loss {float(metrics['loss']):.4f} "
                  f"selected {int(selected.sum())} received "
                  f"{int(received.sum())} eps {float(fstate.epsilon):.2f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    # the run's device numbers, read once at its end
    losses = torch.stack([r["loss"] for r in log]).tolist() if log else []
    eps = torch.stack([r["epsilon"] for r in log]).tolist() if log else []
    for r, loss, e in zip(log, losses, eps):
        r["loss"], r["epsilon"] = loss, e

    if args.ckpt:
        os.makedirs(os.path.dirname(args.ckpt) or ".", exist_ok=True)
        save(args.ckpt, lm_params_to_jax(state.params))
        print("checkpoint saved to", args.ckpt)
    return state, log


if __name__ == "__main__":
    main()
