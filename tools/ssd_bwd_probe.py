#!/usr/bin/env python3
"""Where the time of the tensor-core SSD backward (``ssd_bwd_mma``) goes,
and what its gate catches, on one card.

    python3 tools/ssd_bwd_probe.py [--out DIR] [--fp32]

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

``--fp32`` does the same for the fp32 kernel (``ssd_bwd_mma_f32``, variant
``mma_f32``, its ``// @probe f32 ...`` lines) at zamba2 100m's training
shape (B 32, S 128, H 24, P = N = 64, G 1, fp32): the faults are
``one_term`` (M^T in its leading bf16 term alone in GB = M^T dY) and
``skip_state``, and the gate is ``chip_smoke.py``'s float64 one
(``ssd_f64_ways``: every gradient within ``SSD_F64_RATIO`` of
``ssd_bwd_simt``'s distance from a float64 truth).

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
SHAPE_F32 = (32, 128, 24, 64, 64, 1)
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def variants(src):
    prob, names = probed(src)
    return {"kernel": src,
            "one_term": at(src, "one_term", drop_next=True),
            "skip_state": at(src, "state-update", "      if (c != 1)"),
            "probed": prob}, names


WARPS_F32 = 8                   # warps of a block of ssd_bwd_mma_f32


def variants_f32(src):
    prob, names = probed(src, tag="f32 ", warps=WARPS_F32)
    return {"kernel": src,
            "one_term": at(src, "f32 one_term",
                           "          for (int k = 1; k < kT3; ++k)\n"
                           "            a[k][0] = a[k][1] = a[k][2] = "
                           "a[k][3] = 0u;"),
            "skip_state": at(src, "f32 state-update", "      if (c != 1)"),
            "probed": prob}, names


def entry(lib, variant):
    """The C entry of ``variant`` in ``lib``, typed as the port's."""
    fn = getattr(lib, "ssm_scan_bwd_mma_f32" if variant == "mma_f32"
                 else "ssm_scan_bwd_mma")
    fn.argtypes = SK._bwd_mma_entry(variant).argtypes
    fn.restype = ctypes.c_int
    return fn


def grads(lib, args, dy, variant="mma_bf16"):
    """The gradients of <y, dy> through SSDScanFn with ``lib``'s kernel in
    the wrapper's place."""
    fn = entry(lib, variant)
    saved = SK._bwd_mma_entry
    SK._bwd_mma_entry = lambda *_: fn
    try:
        return CS._grads(ssm_scan, args, dy, None)
    finally:
        SK._bwd_mma_entry = saved


def f64_gate(libs, leaves, dy):
    """The fp32 faults against chip_smoke.py's float64 gate: each copy's
    ratios to ssd_bwd_simt's distance from float64; True if the kernel
    passes and every fault fails."""
    ways = {name: grads(libs[name], leaves, dy, "mma_f32")
            for name in ("kernel", "one_term", "skip_state")}
    dist = CS.ssd_f64_ways(*leaves, dy, None, ways=ways)
    ok, notes = True, []
    for name in ways:
        ratio = {n: dist[name][n] / max(dist["simt"][n], 1e-300)
                 for n in dist[name]}
        passed = max(ratio.values()) <= CS.SSD_F64_RATIO
        ok &= passed == (name == "kernel")
        notes.append(f"{name} {'passes' if passed else 'fails'} ("
                     + ", ".join(f"{n} {r:.3g}" for n, r in ratio.items())
                     + " of simt's float64 distance)")
    print("[ssd_bwd_probe] gate: " + "; ".join(notes))
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "probe_bwd"),
                    help="where the copies of the source are built")
    ap.add_argument("--fp32", action="store_true",
                    help="the fp32 kernel (mma_f32) at zamba2 100m's "
                    "training shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_bwd_probe: no CUDA card visible", file=sys.stderr)
        return 2
    variant = "mma_f32" if args.fp32 else "mma_bf16"
    fault = "one_term"
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "ssm_scan_bwd_mma.cu")) as f:
        copies, names = (variants_f32 if args.fp32 else variants)(f.read())
    libs = build(args.out + ("_f32" if args.fp32 else ""), copies)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}")
    B, S, H, P, N, G = SHAPE_F32 if args.fp32 else SHAPE
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    x, dt, A, Bm, Cm, _ = CS._ssd_inputs(B, S, H, P, N, G, dtype, seed=5)
    dy = torch.randn(x.shape, device="cuda")
    leaves = [x, dt, A, Bm, Cm, None]
    if args.fp32:
        ok = f64_gate(libs, leaves, dy)
    else:
        want = CS._grads(lambda *a: ssm_scan(*a, impl="torch"),
                         [None if t is None else t.float() for t in leaves],
                         dy, None)
        dtypes = [None if t is None else t.dtype for t in leaves]
        ok, gate = True, []
        for name in ("kernel", "one_term", "skip_state"):
            got = grads(libs[name], leaves, dy)
            try:
                err, rel = CS.check_bf16_grads("ssd_bwd_probe", name, NAMES,
                                               got, want, dtypes,
                                               CS.SSM_BWD_TOL)
                note = f"passes ({rel:.3e} of max(1, max |g|))"
                passed = True
            except RuntimeError as e:
                note, passed = f"fails ({e})", False
            ok &= passed == (name == "kernel")
            gate.append(f"{name} {note}")
            del got
        print("[ssd_bwd_probe] gate: " + "; ".join(gate))
    k = [t.transpose(1, 2) for t in (x, dt, Bm, Cm, dy)]
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for _ in range(2):                    # in turns: a, b, a, b
        for name in ("kernel", fault):
            fn = entry(libs[name], variant)
            times.setdefault(name, []).append(CS.cuda_ms(
                lambda: SK.launch_bwd(fn, variant, k[0], k[1], A, k[2],
                                      k[3], None, k[4], None, stream),
                reps=20, warmup=3))
    fn = entry(libs["probed"], variant)
    launch = lambda: SK.launch_bwd(  # noqa: E731
        fn, variant, k[0], k[1], A, k[2], k[3], None, k[4], None, stream)
    lib = libs["probed"]
    launch()
    torch.cuda.synchronize()
    lib.probe_reset()
    launch()
    torch.cuda.synchronize()
    warps = WARPS_F32 if args.fp32 else WARPS
    buf = (ctypes.c_ulonglong * (warps * SLOTS))()
    lib.probe_read(buf)
    per = B * H * math.ceil(S / SK.CHUNK)     # chunks of a head, all heads
    rows = []
    for w in range(warps):
        phases = ", ".join(f"{n} {buf[w * SLOTS + j] / per:.0f}"
                           for j, n in enumerate(names))
        total = sum(buf[w * SLOTS + j] for j in range(len(names))) / per
        rows.append(f"warp {w}: {phases} (sum {total:.0f})")
    print(f"[ssd_bwd_probe] {variant} B{B} S{S} H{H} P{P} N{N} G{G}, "
          f"{1 if args.fp32 else SK.heads_per_block(B, H, G)} heads a "
          f"block: kernel "
          f"{times['kernel']} ms, {fault} {times[fault]} ms (the whole "
          f"call, partial sums included); cycles per chunk by phase:\n  "
          + "\n  ".join(rows))
    if not ok:
        print("ssd_bwd_probe: the gate did not pass the kernel and fail "
              "both faults", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
