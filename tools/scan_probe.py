#!/usr/bin/env python3
"""Where the time of the scan kernels goes, and what their gates catch, on
one card.

    python3 tools/scan_probe.py [--out DIR] [--fp32]

No profiler sees inside a kernel on the machine with the card (``ncu`` does
not run there), so, as ``tools/flash_probe.py`` does for flash, this script
builds copies of ``src/repro_torch/csrc/ssm_scan.cu`` and ``rwkv6_scan.cu``
into ``DIR`` (default ``build/probe/``) and launches their tensor-core
variants (``ssd_fwd_mma``, ``wkv_fwd_mma``) through the port's own wrappers
at the serve prefills' shapes (zamba2-1.2b, rwkv6-7b):

* ``kernel``: the source as it is, timed with CUDA events;
* ``one_term``: one product carried in its leading bf16 term alone (the
  SSD's M' x without M''s low term; the WKV's (r o cp) . S as hi . hi),
  a deliberate fault, timed the same way: what the extra terms cost;
* ``skip_state``: the state update of the second chunk (SSD) or sub-chunk
  (WKV) left out, a deliberate fault;
* ``probed``: the source with ``clock()`` reads at every ``// @probe
  phase:<name>`` line of the chunk loop, summed per warp over all blocks
  into a device array and printed as cycles per chunk of each phase.

Each copy is made at the source's ``// @probe <name>`` lines, so an edit
elsewhere leaves the probe working.  The outputs of ``kernel``,
``one_term`` and ``skip_state`` are held to ``chip_smoke.py``'s own gate
(``_check_scan`` at ``SSM_REL`` / ``WKV_REL`` of max(1, |plain|), plain the
per-step oracle): the script fails unless the kernel passes it and every
fault fails it.

``--fp32`` does the same for the fp32 SSD forward (``ssd_fwd_mma_f32``,
variant ``mma_f32``, its ``// @probe f32 <name>`` lines) at zamba2
100m's training shape (B 32, S 128, H 24, P = N = 64, G 1, fp32): the
faults are M' in its leading term alone and the second chunk's state
update left out (which only the final state shows), held on y and the
state to ``SSM_REL`` of the per-step oracle; and one more copy,
``two_blocks``, the kernel as it is under ``__launch_bounds__`` for two
blocks an SM (up to 255 registers) in place of three, timed in turns
with the kernel and ``ssd_fwd_simt`` at 100m, 10m and the zamba2-1.2b
layer: what the occupancy buys against the registers it costs.

Nothing here is used by the port.  It needs the CUDA toolkit and a card.
"""
import argparse
import contextlib
import ctypes
import math
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from flash_probe import at  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as WK  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter  # noqa
from repro_torch.kernels.ssm_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import ssm_scan  # noqa: E402

WARPS = 4                       # warps of a block of either mma kernel
SLOTS = 8                       # probe slots a warp
# ssd_fwd_mma_f32's launch bounds, and the two-block copy's
F32_BOUNDS = "__launch_bounds__(kMmaThreads, 3)\nssd_fwd_mma_f32("


def probed(src, tag="", warps=WARPS):
    """The source with clock() reads at its ``// @probe <tag>phase:<name>``
    lines (and its ``<tag>start`` and ``<tag>epilogue``: ``tag`` picks
    one kernel of a source that marks two, of ``warps`` warps a block);
    returns (source, phase names)."""
    names = re.findall(rf"// @probe {re.escape(tag)}phase:(\w+)", src)
    if not 0 < len(names) <= SLOTS:
        raise SystemExit(f"scan_probe: {len(names)} phase lines")
    src = (f"__device__ unsigned long long g_probe[{warps * SLOTS}];\n"
           + src)
    src = at(src, f"{tag}start", f"  unsigned pf[{SLOTS}] = {{}};\n"
             "  unsigned c_prev = clock();")
    for k, name in enumerate(names):
        src = at(src, f"{tag}phase:{name}",
                 f"    {{ const unsigned c_now = clock(); pf[{k}] += "
                 f"c_now - c_prev; c_prev = c_now; }}")
    src = at(src, f"{tag}epilogue",
             f"  if (lane == 0)\n"
             f"    for (int k = 0; k < {SLOTS}; ++k)\n"
             f"      atomicAdd(&g_probe[warp * {SLOTS} + k], "
             f"(unsigned long long)pf[k]);")
    src += ('\nextern "C" int probe_read(unsigned long long* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, g_probe, '
            'sizeof(g_probe));\n}\n'
            'extern "C" int probe_reset() {\n'
            f'  unsigned long long z[{warps * SLOTS}] = {{0}};\n'
            '  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n'
            '}\n')
    return src, names


def variants(src):
    """The four copies of one source."""
    prob, names = probed(src)
    return {"kernel": src,
            "one_term": at(src, "one_term", drop_next=True),
            "skip_state": at(src, "state-update", "    if (c != 1)"),
            "probed": prob}, names


def variants_f32(src):
    """The copies of ``ssm_scan.cu`` that ``--fp32`` runs (the fp32
    kernel's probe lines)."""
    prob, names = probed(src, tag="f32 ")
    zero = ("      for (int k = 1; k < kT3; ++k)\n"
            "        for (int m = 0; m < 4; ++m) mt[k][m] = 0u;")
    if src.count(F32_BOUNDS) != 1:
        raise SystemExit("scan_probe: ssd_fwd_mma_f32's launch bounds moved")
    return {"kernel": src,
            "one_term": at(src, "f32 one_term", zero),
            "skip_state": at(src, "f32 state-update", "    if (c != 1)"),
            "two_blocks": src.replace(F32_BOUNDS, F32_BOUNDS.replace(
                ", 3)", ", 2)")),
            "probed": prob}, names


def build(out, sources):
    """Build every copy, one nvcc each, all started together."""
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", os.path.join(out, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"scan_probe: {name} did not build:\n{report}")
        regs = {k.split("_mma")[1][:40]: (r.registers, r.spill_stores)
                for k, r in _build.ptxas_kernels(report).items()
                if "_mma" in k and "fwd" in k}
        print(f"[build] {name}: mma kernels' (registers, spill stores) "
              f"{regs}")
        libs[name] = ctypes.CDLL(os.path.join(out, f"{name}.so"))
    return libs


@contextlib.contextmanager
def entry(module, symbol, lib):
    """The wrapper in ``module`` launches ``lib``'s kernel inside the
    block."""
    fn = getattr(lib, symbol)
    fn.argtypes = module._entry().argtypes
    fn.restype = ctypes.c_int
    saved = module._entry
    module._entry = lambda: fn
    try:
        yield
    finally:
        module._entry = saved


def run(label, module, symbol, libs, names, call, plain, rel, chunks,
        blocks):
    """Gate, times and phases of one kernel; True if the gate passed the
    kernel and failed both faults."""
    want = plain()
    ok, gate = True, []
    for name in ("kernel", "one_term", "skip_state"):
        with entry(module, symbol, libs[name]):
            got = call()
        torch.cuda.synchronize()
        try:
            err, worst = CS._check_scan(label, name, got[0], want[0], rel)
            passed = True
        except RuntimeError:
            err = float((got[0] - want[0]).abs().max())
            worst = float(((got[0] - want[0]).abs()
                           / want[0].abs().clamp_min(1.0)).max())
            passed = False
        ok &= passed == (name == "kernel")
        gate.append(f"{name} {worst:.3e} of max(1, |y|) (max abs err "
                    f"{err:.3e}) {'passes' if passed else 'fails'}")
        del got
    print(f"[{label}] gate ({rel}): {'; '.join(gate)}")
    times = {}
    for _ in range(2):                # in turns: a, b, a, b
        for name in ("kernel", "one_term"):
            with entry(module, symbol, libs[name]):
                times.setdefault(name, []).append(
                    CS.cuda_ms(call, reps=20, warmup=3))
    with entry(module, symbol, libs["probed"]):
        rows = phases(libs["probed"], call, names, blocks * chunks)
    print(f"[{label}] kernel {times['kernel']} ms, one term "
          f"{times['one_term']} ms; cycles per chunk by phase:\n  "
          + "\n  ".join(rows))
    return ok


def phases(lib, call, names, per):
    """Cycles a chunk of each probed phase, per warp, of one call."""
    call()
    torch.cuda.synchronize()
    lib.probe_reset()
    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (WARPS * SLOTS))()
    lib.probe_read(buf)
    rows = []
    for w in range(WARPS):
        row = ", ".join(f"{n} {buf[w * SLOTS + k] / per:.0f}"
                        for k, n in enumerate(names))
        total = sum(buf[w * SLOTS + k] for k in range(len(names))) / per
        rows.append(f"warp {w}: {row} (sum {total:.0f})")
    return rows


def main_f32(args):
    """``--fp32``: the fp32 SSD forward's gate, faults, times and
    phases."""
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "ssm_scan.cu")) as f:
        copies, names = variants_f32(f.read())
    libs = build(args.out + "_f32", copies)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}")
    P, N, G = 64, 64, 1
    ok = True
    for label, B, S, H in CS.SSD_FWD_SHAPES:
        x, dt, A, Bm, Cm, _ = CS._ssd_inputs(B, S, H, P, N, G,
                                             torch.float32, seed=1)
        k = [t.transpose(1, 2) for t in (x, dt, Bm, Cm)]

        def call():
            return ssm_scan(x, dt, A, Bm, Cm)

        def simt():
            return SK.ssm_scan_cuda(k[0], k[1], A, k[2], k[3],
                                    variant="simt")
        reps = 20 if S <= 128 else 5
        if label == "100m training":
            want = ssm_scan(x, dt, A, Bm, Cm, impl="torch")
            gate = []
            for name in ("kernel", "one_term", "skip_state", "two_blocks"):
                with entry(SK, "ssm_scan_fwd", libs[name]):
                    got = call()
                torch.cuda.synchronize()
                worst = max(float(((g - w).abs() / w.abs().clamp_min(1.0))
                                  .max()) for g, w in zip(got, want))
                passed = worst <= CS.SSM_REL and all(
                    bool(torch.isfinite(g).all()) for g in got)
                ok &= passed == (name in ("kernel", "two_blocks"))
                gate.append(f"{name} {worst:.3e} of max(1, |plain|) "
                            f"{'passes' if passed else 'fails'}")
            print(f"[ssm_scan fp32 {label}] gate ({CS.SSM_REL}, y and "
                  f"state): {'; '.join(gate)}")
            with entry(SK, "ssm_scan_fwd", libs["probed"]):
                rows = phases(libs["probed"], call, names,
                              2 * B * H * math.ceil(S / SK.CHUNK))
            print(f"[ssm_scan fp32 {label}] cycles per chunk by phase:\n  "
                  + "\n  ".join(rows))
        times = {}
        for _ in range(2):            # in turns: a, b, c, d, a, b, c, d
            for name in ("kernel", "two_blocks", "one_term"):
                with entry(SK, "ssm_scan_fwd", libs[name]):
                    times.setdefault(name, []).append(
                        CS.cuda_ms(call, reps=reps, warmup=3))
            times.setdefault("simt", []).append(
                CS.cuda_ms(simt, reps=reps, warmup=3))
        bound = max(CS.ssd_fwd_bounds(B, S, H, P, N, G)[2:])
        print(f"[ssm_scan fp32 {label}] (B{B} S{S} H{H}) ms in turns, "
              f"bound {bound * 1e3:.1f} us: " + "; ".join(
                  f"{n} {t[0]:.4f} / {t[1]:.4f} ({bound / min(t):.1%})"
                  for n, t in times.items()))
        del x, dt, A, Bm, Cm, k
        torch.cuda.empty_cache()
    if not ok:
        print("scan_probe: the gate did not pass the kernel and fail both "
              "of its faults", file=sys.stderr)
        return 1
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "probe"),
                    help="where the copies of the sources are built")
    ap.add_argument("--fp32", action="store_true",
                    help="the fp32 SSD forward (mma_f32) at zamba2 100m's "
                    "training shape, and its occupancy in turns at 100m, "
                    "10m and the zamba2-1.2b layer")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA card visible", file=sys.stderr)
        return 2
    if args.fp32:
        return main_f32(args)
    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    srcs, names = {}, {}
    for kern in ("ssm_scan", "rwkv6_scan"):
        with open(os.path.join(csrc, f"{kern}.cu")) as f:
            copies, names[kern] = variants(f.read())
        srcs.update({f"{kern}.{n}": s for n, s in copies.items()})
    built = build(args.out, srcs)
    libs = {kern: {n.split(".")[1]: lib for n, lib in built.items()
                   if n.startswith(kern + ".")}
            for kern in ("ssm_scan", "rwkv6_scan")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}")

    B, S, H, P, N, G, dt_ = CS.SSM_ZAMBA2
    x, dt, A, Bm, Cm, _ = CS._ssd_inputs(*CS.SSM_ZAMBA2, seed=1)
    ok = run("ssm_scan zamba2-1.2b", SK, "ssm_scan_fwd", libs["ssm_scan"],
             names["ssm_scan"], lambda: ssm_scan(x, dt, A, Bm, Cm),
             lambda: ssm_scan(x, dt, A, Bm, Cm, impl="torch"), CS.SSM_REL,
             math.ceil(S / SK.CHUNK), 2 * B * H)
    del x, dt, A, Bm, Cm
    B, S, H, D, _ = CS.WKV_RWKV6
    r, k, v, lw, u, _ = CS._wkv_inputs(*CS.WKV_RWKV6, seed=1)
    kern, plain = wkv_kernel_adapter("cuda"), wkv_kernel_adapter("torch")
    ok &= run("rwkv6_scan rwkv6-7b", WK, "rwkv6_scan_fwd",
              libs["rwkv6_scan"], names["rwkv6_scan"],
              lambda: kern(r, k, v, lw, u, None),
              lambda: plain(r, k, v, lw, u, None), CS.WKV_REL,
              math.ceil(S / WK.SUB), 2 * B * H)
    if not ok:
        print("scan_probe: the gate did not pass a kernel and fail both of "
              "its faults", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
