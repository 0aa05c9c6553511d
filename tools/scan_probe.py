#!/usr/bin/env python3
"""Where the time of the bf16 scan kernels goes, and what their gates catch,
on one card.

    python3 tools/scan_probe.py [--out DIR]

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
                if "_mma" in k}
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
    lib = libs["probed"]
    with entry(module, symbol, lib):
        call()
        torch.cuda.synchronize()
        lib.probe_reset()
        call()
        torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (WARPS * SLOTS))()
    lib.probe_read(buf)
    per = blocks * chunks
    rows = []
    for w in range(WARPS):
        phases = ", ".join(f"{n} {buf[w * SLOTS + k] / per:.0f}"
                           for k, n in enumerate(names))
        total = sum(buf[w * SLOTS + k] for k in range(len(names))) / per
        rows.append(f"warp {w}: {phases} (sum {total:.0f})")
    print(f"[{label}] kernel {times['kernel']} ms, one term "
          f"{times['one_term']} ms; cycles per chunk by phase:\n  "
          + "\n  ".join(rows))
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "probe"),
                    help="where the copies of the sources are built")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA card visible", file=sys.stderr)
        return 2
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
