#!/usr/bin/env python3
"""Where the time of the bf16 SSD backward (``ssd_bwd_mma``) goes, and what
its gate catches, on one card.

    python3 tools/ssd_bwd_probe.py [--out DIR]

As ``tools/scan_probe.py`` does for the bf16 scan forwards, this builds
copies of ``src/repro_torch/csrc/ssm_scan_bwd_mma.cu`` into ``DIR``
(default ``build/probe_bwd/``) and launches them through the port's own
wrapper (``kernel.ssm_scan_bwd_cuda``) at zamba2-1.2b's training shape
(B 32, S 128, H 64, P = N = 64, G 1, bf16 x, B and C, fp32 dt; eight
heads a block):

* ``kernel``: the source as it is, timed with CUDA events;
* ``one_term``: M^T in GB = M^T dY carried in its leading bf16 term alone
  (the lo . hi product left out), a deliberate fault, timed the same way:
  what that term costs;
* ``skip_state``: the Gc update of chunk 1 left out, a deliberate fault;
* ``probed``: the source with ``clock()`` reads at every ``// @probe
  phase:<name>`` line of the reverse walk, summed per warp over all
  blocks and printed as cycles per chunk of each phase.  ``load`` runs
  from the previous chunk's end (for a head's first chunk, from the
  previous head's: its forward walk included) to the chunk's seg;
  ``barrier2`` and ``barrier3`` are the waits at the block barriers.

Each copy is made at the source's ``// @probe <name>`` lines.  The
outputs of ``kernel``, ``one_term`` and ``skip_state`` are held to
``chip_smoke.py``'s own gate (``check_bf16_grads`` at ``SSM_BWD_TOL``
against autograd through the per-step oracle): the script fails unless
the kernel passes it and every fault fails it.

Nothing here is used by the port.  It needs the CUDA toolkit and a card.
"""
import argparse
import ctypes
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as CS  # noqa: E402
from flash_probe import at  # noqa: E402
from scan_probe import SLOTS, WARPS, build, probed  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import ssm_scan  # noqa: E402

SHAPE = (32, 128, 64, 64, 64, 1)          # B, S, H, P, N, G
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def variants(src):
    prob, names = probed(src)
    return {"kernel": src,
            "one_term": at(src, "one_term", drop_next=True),
            "skip_state": at(src, "state-update", "      if (c != 1)"),
            "probed": prob}, names


def grads(lib, args, dy):
    """The gradients of <y, dy> through SSDScanFn with ``lib``'s kernel in
    the wrapper's place."""
    fn = lib.ssm_scan_bwd_mma
    fn.argtypes = SK._bwd_mma_entry().argtypes
    fn.restype = ctypes.c_int
    saved = SK._bwd_mma_entry
    SK._bwd_mma_entry = lambda: fn
    try:
        return CS._grads(ssm_scan, args, dy, None)
    finally:
        SK._bwd_mma_entry = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "probe_bwd"),
                    help="where the copies of the source are built")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_bwd_probe: no CUDA card visible", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "ssm_scan_bwd_mma.cu")) as f:
        copies, names = variants(f.read())
    libs = build(args.out, copies)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}")
    B, S, H, P, N, G = SHAPE
    x, dt, A, Bm, Cm, _ = CS._ssd_inputs(B, S, H, P, N, G, torch.bfloat16,
                                         seed=5)
    dy = torch.randn(x.shape, device="cuda")
    leaves = [x, dt, A, Bm, Cm, None]
    want = CS._grads(lambda *a: ssm_scan(*a, impl="torch"),
                     [None if t is None else t.float() for t in leaves], dy,
                     None)
    dtypes = [None if t is None else t.dtype for t in leaves]
    ok, gate = True, []
    for name in ("kernel", "one_term", "skip_state"):
        got = grads(libs[name], leaves, dy)
        try:
            err, rel = CS.check_bf16_grads("ssd_bwd_probe", name, NAMES, got,
                                           want, dtypes, CS.SSM_BWD_TOL)
            note = f"passes ({rel:.3e} of max(1, max |g|))"
            passed = True
        except RuntimeError as e:
            note, passed = f"fails ({e})", False
        ok &= passed == (name == "kernel")
        gate.append(f"{name} {note}")
        del got
    print("[ssd_bwd_probe] gate: " + "; ".join(gate))
    k = [t.transpose(1, 2) for t in (x, dt, Bm, Cm, dy)]
    times = {}
    for _ in range(2):                    # in turns: a, b, a, b
        for name in ("kernel", "one_term"):
            fn = libs[name].ssm_scan_bwd_mma
            fn.argtypes = SK._bwd_mma_entry().argtypes
            times.setdefault(name, []).append(CS.cuda_ms(
                lambda: SK.launch_bwd(fn, "mma_bf16", k[0], k[1], A, k[2],
                                      k[3], None, k[4], None,
                                      torch.cuda.current_stream()
                                      .cuda_stream), reps=20, warmup=3))
    lib = libs["probed"]
    lib.ssm_scan_bwd_mma.argtypes = SK._bwd_mma_entry().argtypes
    launch = lambda: SK.launch_bwd(  # noqa: E731
        lib.ssm_scan_bwd_mma, "mma_bf16", k[0], k[1], A, k[2], k[3], None,
        k[4], None, torch.cuda.current_stream().cuda_stream)
    launch()
    torch.cuda.synchronize()
    lib.probe_reset()
    launch()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (WARPS * SLOTS))()
    lib.probe_read(buf)
    per = B * H * math.ceil(S / SK.CHUNK)     # chunks of a head, all heads
    rows = []
    for w in range(WARPS):
        phases = ", ".join(f"{n} {buf[w * SLOTS + j] / per:.0f}"
                           for j, n in enumerate(names))
        total = sum(buf[w * SLOTS + j] for j in range(len(names))) / per
        rows.append(f"warp {w}: {phases} (sum {total:.0f})")
    print(f"[ssd_bwd_probe] B{B} S{S} H{H} P{P} N{N} G{G}, "
          f"{SK.heads_per_block(B, H, G)} heads a block: kernel "
          f"{times['kernel']} ms, one term {times['one_term']} ms (the "
          f"whole call, partial sums included); cycles per chunk by "
          f"phase:\n  " + "\n  ".join(rows))
    if not ok:
        print("ssd_bwd_probe: the gate did not pass the kernel and fail "
              "both faults", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
