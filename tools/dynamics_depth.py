#!/usr/bin/env python3
"""Round time of the FL loops in turns on one card: the host-RNG loop and
the device dynamics loop at pipeline depths 1 and 2.

    python3 tools/dynamics_depth.py [--reps 10]

Round times swing with the machine's host from one call to the next (the
loops are host-bound), so one ``chip_smoke.py`` reading a loop cannot
resolve a difference of a few ms.  This script builds three engines at
``chip_smoke.py``'s size (N = 4096, 512 per round, 6 rounds, flude,
``agg_impl="cuda"``): ``host`` (``dynamics="bernoulli_host"``), ``depth 1``
and ``depth 2`` (``dynamics="bernoulli"``).  After a warm-up run of each it
times ``--reps`` cycles, each running the three in an order that rotates
and reverses from cycle to cycle, with ``chip_smoke.timed_run`` (ms per
round over rounds 1-5, host clock after a synchronise).  It prints every
reading, each loop's median and quartiles, and in how many cycles depth 2
beat depth 1 and the device loop (depth 1) beat the host loop; it fails if
the two depths' History rows ever differ.

Nothing here is used by the port.  It needs the CUDA toolkit and a card.
"""
import argparse
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

ARMS = {"host": dict(), "depth 1": dict(dynamics="bernoulli"),
        "depth 2": dict(dynamics="bernoulli", pipeline_depth=2)}


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], statistics.median(xs), q[2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dynamics_depth: no CUDA card visible", file=sys.stderr)
        return 2
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import federated_classification
    from repro_torch.fl import FleetEngine, SimConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, smi = CS.phase_device()
    data = federated_classification(CS.MAIN_N, seed=8)
    sim = SimConfig(num_clients=CS.MAIN_N, rounds=CS.MAIN_ROUNDS)
    engines = {name: FleetEngine(data, sim, FLConfig(
        num_clients=CS.MAIN_N, clients_per_round=CS.MAIN_PER_ROUND,
        agg_impl="cuda", **change)) for name, change in ARMS.items()}
    for engine in engines.values():
        engine.run("flude")                        # build, place, warm up
    names = list(ARMS)
    ms = {name: [] for name in names}
    d2_wins = dev_wins = 0
    for rep in range(args.reps):
        order = names[rep % 3:] + names[:rep % 3]
        if rep % 2:
            order.reverse()
        rows, cycle = {}, {}
        for name in order:
            hist, _, t, _ = CS.timed_run(engines[name], "flude", {})
            ms[name].append(t)
            cycle[name] = t
            rows[name] = hist.to_json()
        if rows["depth 1"] != rows["depth 2"]:
            raise RuntimeError(f"cycle {rep}: depth 1 and depth 2 rows "
                               f"differ")
        d2_wins += cycle["depth 2"] < cycle["depth 1"]
        dev_wins += cycle["depth 1"] < cycle["host"]
        CS.log(f"[depth] cycle {rep} ({', '.join(order)}): " + ", ".join(
            f"{n} {cycle[n]:.2f}" for n in names) + " ms/round")
    summary = {}
    for name in names:
        lo, med, hi = quartiles(ms[name])
        summary[name] = {"median": med, "q1": lo, "q3": hi,
                         "readings": ms[name]}
        CS.log(f"[depth] {name}: median {med:.2f} ms/round, quartiles "
               f"{lo:.2f} / {hi:.2f} over {args.reps} runs")
    CS.log(f"[depth] depth 2 faster than depth 1 in {d2_wins} of "
           f"{args.reps} cycles; depth 1 faster than the host loop in "
           f"{dev_wins} of {args.reps}")
    print(json.dumps({"depth": summary, "depth2_wins": d2_wins,
                      "device_loop_wins": dev_wins, "reps": args.reps}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
