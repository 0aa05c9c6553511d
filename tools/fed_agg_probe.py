#!/usr/bin/env python3
"""Where ``fed_agg``'s time goes at the compact-cohort shapes, on one card.

    python3 tools/fed_agg_probe.py [--reps 200]

For each shape ((512, 22,026), (512, 17,410) and the full scan's (4096,
22,026)) it prints three times of the kernel and of one ``torch.mv`` on
the same inputs (cycled through copies three times the L2, so every
call reads device memory):

- ``host``: the host's time to enqueue one call (the host clock over
  ``--reps`` calls issued behind a long ``torch.cuda._sleep``, so no call
  waits for the card);
- ``events``: ``chip_smoke.cuda_ms``, CUDA events around ``--reps``
  back-to-back calls; where ``host`` exceeds the device time the card
  waits for the host between calls and this reads the host;
- ``device``: the same events with the calls queued behind a
  ``torch.cuda._sleep`` long enough to cover their enqueue, so the card
  runs them back to back: the device time alone.

Then the kernel's device time over a sweep of its geometry (``WAVE``,
blocks a wave; ``block_d``), each variant's output held to
``fed_agg_ref`` at ``chip_smoke.REL_TOL`` and the bound beside it.  The
last two lines are a JSON object of every reading and the card's name
and power limit.

Nothing here is used by the port.  It needs the CUDA toolkit and a card.
"""
import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

SHAPES = [(CS.COHORT_X, CS.MAIN_D), (CS.COHORT_X, CS.D_1M),
          (CS.MAIN_N, CS.MAIN_D)]
SWEEP_WAVE = (132, 264, 528)
SWEEP_BLOCK_D = (512, 1024, 2048)


def sleep_cycles(ms):
    """Cycles of ``torch.cuda._sleep`` for about ``ms`` at the SM's
    clock (read once: the rate of ``_sleep`` over a known span)."""
    probe = 10_000_000
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    torch.cuda.synchronize()
    return int(probe * ms / start.elapsed_time(end))


def host_and_device_us(fn, reps, cycles_per_ms):
    """(host µs to enqueue one call, device µs a call back to back)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 200 µs of host a call is far more than any wrapper here takes
    torch.cuda._sleep(int(cycles_per_ms * reps * 0.2) + cycles_per_ms)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    end.record()
    torch.cuda.synchronize()
    return host_us, start.elapsed_time(end) / reps * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fed_agg_probe: no CUDA card visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.fed_agg import kernel as K
    from repro_torch.kernels.fed_agg.ref import fed_agg_ref
    _, _, smi = CS.phase_device()
    _build.build_all(["fed_agg"])
    cycles_per_ms = sleep_cycles(1.0)
    out = {"shapes": []}
    wave0 = K.WAVE
    for C, D in SHAPES:
        u, w = CS._agg_inputs(C, D, seed=1)
        nbytes = (C * D + C + D) * 4
        bound_us = nbytes / CS.H100_BYTES_PER_S * 1e6
        want = fed_agg_ref(u, w)
        scale = fed_agg_ref(u.abs(), w.abs())
        row = {"at": [C, D], "bound_us": bound_us}
        copies = CS.l2_copies(u, w)
        for name, fn in (("kernel", CS.rotating(K.fed_agg_cuda, copies)),
                         ("torch.mv", CS.rotating(
                             lambda u, w: torch.mv(u.t(), w), copies))):
            host, dev = host_and_device_us(fn, args.reps, cycles_per_ms)
            ev = CS.cuda_ms(fn, reps=args.reps) * 1e3
            row[name] = {"host_us": host, "events_us": ev,
                         "device_us": dev}
            CS.log(f"[probe] ({C}, {D}) {name}: host {host:.1f} us a call,"
                   f" events {ev:.1f} us, device {dev:.1f} us; bound "
                   f"{bound_us:.1f} us ({bound_us / dev:.1%})")
        sweep = []
        for wave in SWEEP_WAVE:
            for block_d in SWEEP_BLOCK_D:
                K.WAVE = wave
                try:
                    g = K.geometry(C, D, block_d=block_d)
                    got = K.fed_agg_cuda(u, w, block_d=block_d)
                    ok = bool(((got - want).abs()
                               <= CS.REL_TOL * scale + 1e-30).all())
                    _, dev = host_and_device_us(CS.rotating(
                        lambda u, w: K.fed_agg_cuda(u, w, block_d=block_d),
                        copies), args.reps, cycles_per_ms)
                finally:
                    K.WAVE = wave0
                sweep.append({"wave": wave, "block_d": block_d,
                              "col_blocks": g.col_blocks,
                              "n_chunks": g.n_chunks, "device_us": dev,
                              "agrees": ok})
                CS.log(f"[probe] ({C}, {D}) WAVE {wave} block_d {block_d}: "
                       f"{g.col_blocks} x {g.n_chunks} blocks, device "
                       f"{dev:.1f} us ({bound_us / dev:.1%} of bound), "
                       f"agrees {ok}")
                if not ok:
                    raise RuntimeError(f"fed_agg at ({C}, {D}), WAVE {wave},"
                                       f" block_d {block_d} disagrees")
        row["sweep"] = sweep
        out["shapes"].append(row)
        del u, w, want, scale, copies
    print(json.dumps(out))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
