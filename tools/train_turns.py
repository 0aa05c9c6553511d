"""ms/round of fp32 zamba2 training with the SSD's two fp32 variants in
turns, in one process on one card: the backward's, or with ``--forward``
the forward's.

    PYTHONPATH=src python3 tools/train_turns.py [--forward]
        [--scales 10m 100m] [--rounds 30] [--turns 2]

Runs ``repro_torch.launch.train`` (``--arch zamba2-1.2b --scale S``, 8
silos x 4 x 128 tokens a round, as ``chip_smoke.py``'s ``[train zamba2
S]``) once unmeasured to warm the build and the allocator, then
alternately with the fp32 SSD kernel's default (``mma_f32``) and with
the SIMT kernel in its place: ``ssd_bwd_simt``
(``kernel.BWD_VARIANTS[torch.float32]`` set for the run) or, with
``--forward``, ``ssd_fwd_simt`` (``kernel.VARIANTS[torch.float32]``):
mma_f32, simt, mma_f32, simt, ...  Prints each run's ms/round over
rounds 1 to R - 2 (host clock, each round's plan read-back waiting for
the previous step, as ``chip_smoke.py`` reads it), the swapped kernel's
launches by variant and the loss of the first and last round, then each
variant's mean.  After the turns, one ``flude-paper`` run (no
SSD) reads the host against earlier runs of ``chip_smoke.py``'s
``[train flude-paper]``.

Nothing here is used by the port.  It needs the CUDA toolkit and a card.
"""
import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels.ssm_scan import kernel as SK  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402


def run(argv, rounds, variant=None, forward=False):
    """One ``launch.train`` run with ``variant`` as the fp32 SSD backward,
    or forward with ``forward`` (None: the default); (ms/round, that
    kernel's launches by variant, first and last loss)."""
    table, counter = (SK.VARIANTS, SK.launches) if forward else \
        (SK.BWD_VARIANTS, SK.bwd_launches)
    default = table[torch.float32]
    if variant is not None:
        table[torch.float32] = variant
    counter.reset()
    try:
        _, rows = T.main(argv + ["--device", "cuda", "--rounds", str(rounds),
                                 "--log-every", str(rounds)])
        torch.cuda.synchronize()
    finally:
        table[torch.float32] = default
    ms = (rows[-1]["t"] - rows[1]["t"]) * 1e3 / (rounds - 2)
    return ms, dict(counter.by_variant), rows[0]["loss"], rows[-1]["loss"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scales", nargs="+", default=["10m", "100m"])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--forward", action="store_true",
                    help="swap the forward's variant, not the backward's")
    args = ap.parse_args()
    kernel = "forward" if args.forward else "backward"
    if not torch.cuda.is_available():
        print("train_turns: no CUDA card visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}")
    for scale in args.scales:
        argv = ["--arch", "zamba2-1.2b", "--scale", scale]
        run(argv, args.rounds)
        times = {"mma_f32": [], "simt": []}
        for _ in range(args.turns):
            for variant in times:
                ms, by, first, last = run(argv, args.rounds, variant,
                                          args.forward)
                if by.get(variant, 0) == 0 or sum(by.values()) != by[variant]:
                    raise RuntimeError(f"zamba2 {scale} {variant}: the SSD "
                                       f"{kernel} ran {by}")
                times[variant].append(ms)
                print(f"[train_turns] zamba2 {scale} {variant} {kernel}: "
                      f"{ms:.2f} ms/round over rounds 1-{args.rounds - 2}, "
                      f"SSD {kernel} launches {by}, loss {first:.4f} -> "
                      f"{last:.4f}")
        mean = {v: sum(t) / len(t) for v, t in times.items()}
        print(f"[train_turns] zamba2 {scale} mean ms/round, {kernel}: "
              + ", ".join(f"{v} {m:.2f}" for v, m in mean.items())
              + f"; simt - mma_f32 {mean['simt'] - mean['mma_f32']:.2f} ms")
    ms, _, first, last = run(["--arch", "flude-paper"], 40)
    print(f"[train_turns] flude-paper: {ms:.2f} ms/round over rounds 1-38, "
          f"loss {first:.4f} -> {last:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
