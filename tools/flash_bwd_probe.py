#!/usr/bin/env python3
"""Where the time of the tensor-core flash backwards goes, on one card: the
bf16 one (``flash_bwd_wgmma``) or, with ``--fp32``, the fp32 one
(``flash_bwd_f32``: ``flash_split3``, ``_dq``, ``_dkdv``).

    python3 tools/flash_bwd_probe.py [--fp32] [--out DIR]

No profiler sees inside a kernel on the machine with the card, so this
script builds copies of ``src/repro_torch/csrc/flash_attention_bwd.cu``
into ``DIR`` (default ``build/bwd_probe/``, with ``-I`` the source's
directory for ``wgmma.cuh``) and launches them through the port's own
wrapper at ``chip_smoke.py``'s ``FLASH_BWD_BF16_SHAPES``:

* ``kernel``: the source as it is; ``one_term``: the low bf16 term of P
  and dS dropped from the dQ, dK and dV products (what carrying two
  terms costs; its gradients are wrong by design), both timed with CUDA
  events in turns, each call's two kernels also timed apart by
  ``torch.profiler``;
* ``probed``: the source with ``clock64()`` reads at its ``// @probe``
  lines, summed by thread 0 of each consumer warpgroup into a device
  array.  Printed per block of each kernel (dq: the wait for the Q and
  dO tiles, walk 1, walk 2, the epilogue; dk/dv: the wait for K and V,
  the walk, the epilogue) and, for dk/dv, per streamed tile: the wait
  for its TMA copies, S^T and dP^T from issue to completion (with the
  previous tile's dK or dV product beside them), forming P^T or dS^T,
  the wait for the previous product, the packing into bf16 terms.  The
  probes cost a few cycles each.

Also printed: each kernel's blocks, waves of one block an SM (132 SMs)
and cycles of a block times waves, against the kernel's time.

``--fp32`` does the same at ``chip_smoke.py``'s ``FLASH_BWD_SHAPES``
(fp32, D <= 64) with the ``// @probe f32-...`` lines: ``kernel`` timed
(and with the other choice of ``per_head_blocks``, in turns, host clock
around CUDA events), each kernel of a call by ``torch.profiler`` (the split
pre-pass, dq, dk/dv and the group sum of the partials), and ``probed``:
dq's phases (the wait for Q and dO, walk 1, walk 2, the epilogue) and
dk/dv's, per streamed tile of its split consumer: the wait for its TMA
copies, S^T and dP^T (six term products each, start to completion),
forming P^T and dS^T (expf, the masks, r and delta), packing them into
three bf16 terms, and dV and dK (each a zeroed partial, waited for and
added).  Nothing here is used by the port.  It needs the CUDA toolkit
and a card.
"""
import argparse
import contextlib
import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402

SLOTS = 16
DQ = ("Q/dO wait", "walk 1", "walk 2", "epilogue")
KV = ("K/V wait", "walk", "epilogue")
TILE = ("full barrier", "S, dP", "P or dS", "product wait", "pack")


def at(src, name, code):
    """``src`` with ``code`` inserted after its ``// @probe <name>``
    line."""
    lines = src.split("\n")
    hits = [i for i, line in enumerate(lines)
            if re.fullmatch(rf"\s*// @probe {re.escape(name)}\b.*", line)]
    if len(hits) != 1:
        raise SystemExit(f"flash_bwd_probe: the source has {len(hits)} "
                         f"'// @probe {name}' lines, not one")
    i = hits[0]
    return "\n".join(lines[:i + 1] + [code] + lines[i + 1:])


def one_term(src):
    """The low term dropped: the line after ``// @probe lo-term``."""
    lines = src.split("\n")
    i = [n for n, line in enumerate(lines) if "// @probe lo-term" in line]
    if len(i) != 1:
        raise SystemExit("flash_bwd_probe: no single lo-term probe line")
    return "\n".join(lines[:i[0] + 1] + lines[i[0] + 2:])


def probed(src):
    """The source with clock64() probes: slots 0-3 dq phases, 4 dq
    warpgroups; 5-7 dk/dv phases, 8-12 its tile phases, 13 its tiles, 14
    its warpgroups."""
    src = src.replace('#include "wgmma.cuh"\n',
                      '#include "wgmma.cuh"\n'
                      f"__device__ unsigned long long g_probe[{SLOTS}];\n", 1)
    c = "clock64()"
    src = at(src, "dq-start", f"  const long long d0 = {c};")
    src = at(src, "dq-loaded", f"  const long long d1 = {c};")
    src = at(src, "dq-walk1", f"  const long long d2 = {c};")
    src = at(src, "dq-walk2", f"  const long long d3 = {c};")
    src = at(src, "dq-end",
             f"  const long long d4 = {c};\n"
             "  if (t == 0) {\n"
             "    atomicAdd(&g_probe[0], (unsigned long long)(d1 - d0));\n"
             "    atomicAdd(&g_probe[1], (unsigned long long)(d2 - d1));\n"
             "    atomicAdd(&g_probe[2], (unsigned long long)(d3 - d2));\n"
             "    atomicAdd(&g_probe[3], (unsigned long long)(d4 - d3));\n"
             "    atomicAdd(&g_probe[4], 1ull);\n  }")
    src = at(src, "kv-start", f"  const long long v0 = {c};\n"
             "  long long tf[5] = {0, 0, 0, 0, 0};")
    src = at(src, "kv-loaded", f"  const long long v1 = {c};")
    src = at(src, "kv-tile-wait", f"    const long long e0 = {c};")
    src = at(src, "kv-tile-ready", f"    const long long e1 = {c};")
    src = at(src, "kv-scores", f"    const long long e2 = {c};")
    src = at(src, "kv-rs-wait", f"    const long long e3 = {c};")
    src = at(src, "kv-rs-done", f"    const long long e4 = {c};")
    src = at(src, "kv-packed",
             f"    const long long e5 = {c};\n"
             "    tf[0] += e1 - e0; tf[1] += e2 - e1; tf[2] += e3 - e2;\n"
             "    tf[3] += e4 - e3; tf[4] += e5 - e4;")
    src = at(src, "kv-loop-end", f"  const long long v2 = {c};")
    src = at(src, "kv-end",
             f"  const long long v3 = {c};\n"
             "  if (t == 0) {\n"
             "    atomicAdd(&g_probe[5], (unsigned long long)(v1 - v0));\n"
             "    atomicAdd(&g_probe[6], (unsigned long long)(v2 - v1));\n"
             "    atomicAdd(&g_probe[7], (unsigned long long)(v3 - v2));\n"
             "    for (int i = 0; i < 5; ++i)\n"
             "      atomicAdd(&g_probe[8 + i], (unsigned long long)tf[i]);\n"
             "    atomicAdd(&g_probe[13], (unsigned long long)n_iter);\n"
             "    atomicAdd(&g_probe[14], 1ull);\n  }")
    return src + ('\nextern "C" int probe_read(unsigned long long* out) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_probe, '
                  'sizeof(g_probe));\n}\n'
                  'extern "C" int probe_reset() {\n'
                  f'  unsigned long long z[{SLOTS}] = {{0}};\n'
                  '  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n'
                  '}\n')


F32_TILE = ("full barrier", "S^T, dP^T", "P^T, dS^T", "pack", "dV, dK")


def probed_f32(src):
    """The source with clock64() probes in the fp32 kernels, in the slots
    of ``probed``: 0-3 dq phases, 4 dq warpgroups; 5-7 dk/dv phases, 8-12
    its tile phases (``F32_TILE``), 13 its tiles, 14 its warpgroups."""
    src = src.replace('#include "wgmma.cuh"\n',
                      '#include "wgmma.cuh"\n'
                      f"__device__ unsigned long long g_probe[{SLOTS}];\n", 1)
    c = "clock64()"
    src = at(src, "f32-dq-start", f"  const long long d0 = {c};")
    src = at(src, "f32-dq-loaded", f"  const long long d1 = {c};")
    src = at(src, "f32-dq-walk1", f"  const long long d2 = {c};")
    src = at(src, "f32-dq-walk2", f"  const long long d3 = {c};")
    src = at(src, "f32-dq-end",
             f"  const long long d4 = {c};\n"
             "  if (t == 0) {\n"
             "    atomicAdd(&g_probe[0], (unsigned long long)(d1 - d0));\n"
             "    atomicAdd(&g_probe[1], (unsigned long long)(d2 - d1));\n"
             "    atomicAdd(&g_probe[2], (unsigned long long)(d3 - d2));\n"
             "    atomicAdd(&g_probe[3], (unsigned long long)(d4 - d3));\n"
             "    atomicAdd(&g_probe[4], 1ull);\n  }")
    src = at(src, "f32-kv-start", f"  const long long v0 = {c};\n"
             "  long long tf[5] = {0, 0, 0, 0, 0};")
    src = at(src, "f32-kv-loaded", f"  const long long v1 = {c};")
    src = at(src, "f32-kv-tile-wait", f"    const long long e0 = {c};")
    src = at(src, "f32-kv-tile-ready", f"    const long long e1 = {c};")
    src = at(src, "f32-kv-scores", f"    const long long e2 = {c};")
    src = at(src, "f32-kv-formed", f"    const long long e3 = {c};")
    src = at(src, "f32-kv-packed", f"    const long long e4 = {c};")
    src = at(src, "f32-kv-products",
             f"    const long long e5 = {c};\n"
             "    tf[0] += e1 - e0; tf[1] += e2 - e1; tf[2] += e3 - e2;\n"
             "    tf[3] += e4 - e3; tf[4] += e5 - e4;")
    src = at(src, "f32-kv-loop-end", f"  const long long v2 = {c};")
    src = at(src, "f32-kv-end",
             f"  const long long v3 = {c};\n"
             "  if (t == 0) {\n"
             "    atomicAdd(&g_probe[5], (unsigned long long)(v1 - v0));\n"
             "    atomicAdd(&g_probe[6], (unsigned long long)(v2 - v1));\n"
             "    atomicAdd(&g_probe[7], (unsigned long long)(v3 - v2));\n"
             "    for (int i = 0; i < 5; ++i)\n"
             "      atomicAdd(&g_probe[8 + i], (unsigned long long)tf[i]);\n"
             "    atomicAdd(&g_probe[13], (unsigned long long)n_iter);\n"
             "    atomicAdd(&g_probe[14], 1ull);\n  }")
    return src + ('\nextern "C" int probe_read(unsigned long long* out) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_probe, '
                  'sizeof(g_probe));\n}\n'
                  'extern "C" int probe_reset() {\n'
                  f'  unsigned long long z[{SLOTS}] = {{0}};\n'
                  '  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n'
                  '}\n')


def build(out, variants):
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             os.path.join(out, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_bwd_probe: {name} did not build:\n"
                             f"{report}")
        regs = {m.group(0): r
                for k, r in _build.ptxas_kernels(report).items()
                for m in [re.search(r"(wgmma|f32)_(dq|dkdv)ILi(\d+)E", k)]
                if m}
        print(f"[build] {name}: {len(_build.wgmma_serialised(report))} "
              f"serialised-wgmma lines; spill stores "
              f"{ {k: r.spill_stores for k, r in sorted(regs.items())} }")
        libs[name] = ctypes.CDLL(os.path.join(out, f"{name}.so"))
    return libs


@contextlib.contextmanager
def entry(lib, fp32=False):
    """The wrapper launches ``lib``'s kernels inside the block."""
    name = "_bwd_f32_entry" if fp32 else "_bwd_wgmma_entry"
    fn = getattr(lib, "flash_attention_bwd_f32" if fp32
                 else "flash_attention_bwd_wgmma")
    fn.argtypes = getattr(FK, name)().argtypes
    fn.restype = ctypes.c_int
    saved = getattr(FK, name)
    setattr(FK, name, lambda: fn)
    try:
        yield
    finally:
        setattr(FK, name, saved)


def ms(fn, reps):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_us(fn, pattern=r"flash_bwd_wgmma_(dq|dkdv)"):
    """Device microseconds of each kernel of one call whose name matches
    ``pattern`` (group 1 names it), by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(pattern, e.key)
        if m and e.device_time_total > 0:
            out[m.group(1)] = e.device_time_total / 3
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bwd_probe"),
                    help="where the copies of the source are built")
    ap.add_argument("--fp32", action="store_true",
                    help="the fp32 backward at FLASH_BWD_SHAPES")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA card visible", file=sys.stderr)
        return 2
    import chip_smoke as CS
    path = os.path.join(str(_build.CSRC), "flash_attention_bwd.cu")
    with open(path) as f:
        src = f.read()
    if args.fp32:
        return main_fp32(CS, src, args.out)
    libs = build(args.out, {"kernel": src, "one_term": one_term(src),
                            "probed": probed(src)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, B, Hq, Hkv, S, D, W in CS.FLASH_BWD_BF16_SHAPES:
        bf16 = torch.bfloat16
        q, k, v = CS._flash_inputs(B, Hq, Hkv, S, S, D, bf16, seed=2)
        dout = torch.randn(q.shape, device="cuda").to(bf16)
        kw = dict(causal=True, window=W)
        out, lse = FK.flash_attention_cuda(q, k, v, with_lse=True, **kw)

        def call():
            return FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        reps = 20 if S <= 128 else 5
        times = {}
        for _ in range(2):            # in turns: a, b, a, b
            for name in ("kernel", "one_term"):
                with entry(libs[name]):
                    times.setdefault(name, []).append(ms(call, reps))
        with entry(libs["kernel"]):
            split = kernel_us(call)
        with entry(libs["probed"]):
            call()
            torch.cuda.synchronize()
            libs["probed"].probe_reset()
            call()
            torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * SLOTS)()
        libs["probed"].probe_read(buf)
        per_head = FK.per_head_blocks(B, Hq, Hkv, S)
        blocks = {"dq": B * Hq * -(-S // 128),
                  "dkdv": B * (Hq if per_head else Hkv) * -(-S // 64)}
        dq_wg, kv_wg = max(buf[4], 1), max(buf[14], 1)
        tiles = max(buf[13], 1)
        dq = ", ".join(f"{n} {buf[i] / dq_wg:.0f}" for i, n in enumerate(DQ))
        kv = ", ".join(f"{n} {buf[5 + i] / kv_wg:.0f}"
                       for i, n in enumerate(KV))
        tile = ", ".join(f"{n} {buf[8 + i] / tiles:.0f}"
                         for i, n in enumerate(TILE))
        print(f"[{label}] (B{B} Hq{Hq}/{Hkv} S{S} D{D} window {W}) kernel "
              f"{times['kernel']} ms, one term {times['one_term']} ms; "
              f"by kernel (us) {split}")
        for name, n in blocks.items():
            per = sum(buf[i] for i in ((0, 1, 2, 3) if name == "dq"
                                       else (5, 6, 7))) \
                / (dq_wg if name == "dq" else kv_wg)
            waves = n / sms
            print(f"[{label}] {name}: {n} blocks, {waves:.2f} waves of one "
                  f"block an SM; a warpgroup's cycles per block {per:.0f}, "
                  f"x waves {per * waves:.0f}")
        print(f"[{label}] dq cycles per warpgroup: {dq}")
        print(f"[{label}] dk/dv cycles per warpgroup: {kv}; per streamed "
              f"tile ({tiles / kv_wg:.2f} a warpgroup): {tile}")
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return 0


def main_fp32(CS, src, out):
    libs = build(out, {"kernel": src, "probed": probed_f32(src)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, B, Hq, Hkv, S, D, W in CS.FLASH_BWD_SHAPES:
        q, k, v = CS._flash_inputs(B, Hq, Hkv, S, S, D, torch.float32, seed=2)
        dout = torch.randn(q.shape, device="cuda")
        kw = dict(causal=True, window=W)
        out, lse = FK.flash_attention_cuda(q, k, v, with_lse=True, **kw)

        def call():
            return FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        per_head = FK.per_head_blocks(B, Hq, Hkv, S, torch.float32)
        reps = 20 if S <= 128 else 5
        times = {}
        below = FK.PER_HEAD_BELOW_F32
        other = "group a block" if per_head else "one head a block"
        with entry(libs["kernel"], fp32=True):
            for _ in range(2):        # in turns: a, b, a, b
                times.setdefault("kernel", []).append(ms(call, reps))
                if Hq > Hkv:
                    FK.PER_HEAD_BELOW_F32 = 0 if per_head else 1 << 62
                    times.setdefault(other, []).append(ms(call, reps))
                    FK.PER_HEAD_BELOW_F32 = below
            split = kernel_us(call, r"(split3|f32_dq|f32_dkdv|reduce|"
                                    r"elementwise|copy)")
        with entry(libs["probed"], fp32=True):
            call()
            torch.cuda.synchronize()
            libs["probed"].probe_reset()
            call()
            torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * SLOTS)()
        libs["probed"].probe_read(buf)
        rows = 128 if D <= 64 else 64
        blocks = {"dq": B * Hq * -(-S // rows),
                  "dkdv": B * (Hq if per_head else Hkv) * -(-S // 64)}
        dq_wg, kv_wg = max(buf[4], 1), max(buf[14], 1)
        tiles = max(buf[13], 1)
        print(f"[{label}] (B{B} Hq{Hq}/{Hkv} S{S} D{D} window {W}, one "
              f"query head a dk/dv block: {per_head}) ms {times}; by "
              f"kernel (us) {split}")
        for name, n in blocks.items():
            per = sum(buf[i] for i in ((0, 1, 2, 3) if name == "dq"
                                       else (5, 6, 7))) \
                / (dq_wg if name == "dq" else kv_wg)
            print(f"[{label}] {name}: {n} blocks, {n / sms:.2f} waves of one "
                  f"block an SM; a warpgroup's cycles per block {per:.0f}")
        print(f"[{label}] dq cycles per warpgroup: " + ", ".join(
            f"{n} {buf[i] / dq_wg:.0f}" for i, n in enumerate(DQ)))
        print(f"[{label}] dk/dv cycles per warpgroup: " + ", ".join(
            f"{n} {buf[5 + i] / kv_wg:.0f}" for i, n in enumerate(KV))
            + f"; per streamed tile ({tiles / kv_wg:.2f} a warpgroup): "
            + ", ".join(f"{n} {buf[8 + i] / tiles:.0f}"
                        for i, n in enumerate(F32_TILE)))
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
