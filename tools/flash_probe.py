#!/usr/bin/env python3
"""Where the time of the bf16 ``flash_attention`` kernel goes, and what its
gate catches, on one card.

    python3 tools/flash_probe.py [--fp32] [--out DIR]

No profiler sees inside a kernel on the machine with the card (``ncu`` does
not run there), so this script builds copies of
``src/repro_torch/csrc/flash_attention.cu`` into ``DIR`` (default
``build/probe/``) and launches them through the port's own wrapper at the
serve prefills' shapes (Qwen2-7B, H2O-Danube-1.8B, zamba2-1.2b):

* ``kernel``: the source as it is, timed with CUDA events;
* ``one_term``: P's low bf16 term dropped from P·V, timed the same way:
  what carrying P in two terms costs;
* ``skip_tile``: the second kv tile every query tile walks left out of
  its rows, a deliberate fault;
* ``probed``: the source with ``clock()`` reads around each phase of a
  consumer warpgroup's kv-tile loop, summed by thread 0 of every
  warpgroup into a device array.  Printed per kv tile: the wait for the
  tile's TMA copies (full barrier), S = QKᵀ from issue to completion (with
  the previous tile's P·V issued beside it), the softmax, the wait for
  that P·V, the rescale and the packing of P; and per warpgroup the
  prologue before the loop.  The probes cost a few cycles each.

Each copy is made at the source's ``// @probe <name>`` lines, so an edit
elsewhere in the kernel leaves the probe working.  The outputs of
``kernel``, ``one_term`` and ``skip_tile`` are held to the bf16 gate of
``chip_smoke.py`` (``ref.bf16_excess`` <= ``ref.BF16_FLOOR``): the script
fails unless the kernel passes it and both faults fail it.

``--fp32`` does the same for the fp32 tensor-core forward
(``flash_fwd_f32``, variant ``wgmma_f32``) at ``chip_smoke.py``'s fp32
training shapes (``FLASH_BWD_SHAPES`` without the window), with the
source's ``// @probe f32-...`` lines: ``kernel`` timed in turns with
``flash_fwd_simt`` by name (CUDA events), each kernel of a call by
``torch.profiler`` (the split pre-pass ``flash_split3`` and
``flash_fwd_f32``), and ``probed``: per kv tile of a consumer warpgroup
the wait for its TMA copies, S from issue to completion (six term
products, with the previous tile's P V issued beside it), the softmax,
the wait for that P V and O's fma update, and P's split into three bf16
terms; per warpgroup the prologue (the Q tile's wait), the loop with
the last tile's P V, and the epilogue; and blocks, waves of one block
an SM and a warpgroup's cycles times waves against the kernel's time.

Nothing here is used by the port.  It needs the CUDA toolkit and a card.
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

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    BF16_FLOOR, attention_ref, bf16_excess)

# (B, Hq, Hkv, S, D, window) of the three bf16 serve prefills, causal
SHAPES = {"qwen2-7b": (4, 28, 4, 2048, 128, None),
          "h2o-danube-1.8b": (2, 32, 8, 6144, 80, 4096),
          "zamba2-1.2b": (4, 32, 32, 4096, 64, None)}
PHASES = ("full barrier", "S", "softmax", "P V wait", "rescale + pack")


def at(src, name, code="", drop_next=False):
    """``src`` with ``code`` inserted after its ``// @probe <name>`` line
    (and the line after that dropped if ``drop_next``)."""
    lines = src.split("\n")
    hits = [i for i, line in enumerate(lines)
            if re.fullmatch(rf"\s*// @probe {re.escape(name)}\b.*", line)]
    if len(hits) != 1:
        raise SystemExit(f"flash_probe: the source has {len(hits)} "
                         f"'// @probe {name}' lines, not one")
    i = hits[0]
    return "\n".join(lines[:i + 1] + ([code] if code else [])
                     + lines[i + 2 if drop_next else i + 1:])


def probed(src):
    """The source with clock() probes in the consumer's kv-tile loop."""
    src = "__device__ unsigned long long g_probe[8];\n" + src
    src = at(src, "start", "    const unsigned c_start = clock();\n"
             "    unsigned pf[5] = {0, 0, 0, 0, 0};")
    src = at(src, "loop", "    const unsigned c_loop = clock();")
    src = at(src, "tile-wait", "      const unsigned c0 = clock();")
    src = at(src, "tile-ready", "      const unsigned c1 = clock();")
    src = at(src, "scores", "      const unsigned c2 = clock();")
    src = at(src, "pv-wait", "      const unsigned c3 = clock();")
    src = at(src, "pv-done", "      const unsigned c4 = clock();")
    src = at(src, "packed",
             "      const unsigned c5 = clock();\n"
             "      pf[0] += c1 - c0; pf[1] += c2 - c1; pf[2] += c3 - c2;\n"
             "      pf[3] += c4 - c3; pf[4] += c5 - c4;")
    src = at(src, "epilogue",
             "    if (t == 0) {\n"
             "      for (int i = 0; i < 5; ++i)\n"
             "        atomicAdd(&g_probe[i], (unsigned long long)pf[i]);\n"
             "      atomicAdd(&g_probe[5], (unsigned long long)(c_loop - "
             "c_start));\n"
             "      atomicAdd(&g_probe[6], (unsigned long long)(n_tiles - 1));\n"
             "      atomicAdd(&g_probe[7], 1ull);\n    }")
    return src + ('\nextern "C" int probe_read(unsigned long long* out) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_probe, '
                  'sizeof(g_probe));\n}\n'
                  'extern "C" int probe_reset() {\n'
                  '  unsigned long long z[8] = {0};\n'
                  '  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n'
                  '}\n')


F32_PHASES = ("full barrier", "S (P V beside it)", "softmax",
              "P V wait + O update", "split P")
F32_SLOTS = 10


def probed_f32(src):
    """The source with clock64() probes in the fp32 consumer's loop."""
    src = ("__device__ unsigned long long g_probe[%d];\n" % F32_SLOTS) + src
    src = at(src, "f32-start", "  const long long c_start = clock64();\n"
             "  long long pf[5] = {0, 0, 0, 0, 0};")
    src = at(src, "f32-loop", "  const long long c_loop = clock64();")
    src = at(src, "f32-tile-wait", "    const long long c0 = clock64();")
    src = at(src, "f32-tile-ready", "    const long long c1 = clock64();")
    src = at(src, "f32-scores", "    const long long c2 = clock64();")
    src = at(src, "f32-softmax", "    const long long c3 = clock64();")
    src = at(src, "f32-pv-done", "    const long long c4 = clock64();")
    src = at(src, "f32-packed",
             "    const long long c5 = clock64();\n"
             "    pf[0] += c1 - c0; pf[1] += c2 - c1; pf[2] += c3 - c2;\n"
             "    pf[3] += c4 - c3; pf[4] += c5 - c4;")
    src = at(src, "f32-epilogue", "  const long long c_epi = clock64();")
    src = at(src, "f32-end",
             "  if (t == 0) {\n"
             "    for (int i = 0; i < 5; ++i)\n"
             "      atomicAdd(&g_probe[i], (unsigned long long)pf[i]);\n"
             "    atomicAdd(&g_probe[5], (unsigned long long)(c_loop - "
             "c_start));\n"
             "    atomicAdd(&g_probe[6], (unsigned long long)(c_epi - "
             "c_loop));\n"
             "    atomicAdd(&g_probe[7], (unsigned long long)(clock64() - "
             "c_epi));\n"
             "    atomicAdd(&g_probe[8], (unsigned long long)n_tiles);\n"
             "    atomicAdd(&g_probe[9], 1ull);\n  }")
    return src + ('\nextern "C" int probe_read(unsigned long long* out) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_probe, '
                  'sizeof(g_probe));\n}\n'
                  'extern "C" int probe_reset() {\n'
                  '  unsigned long long z[%d] = {0};\n'
                  '  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n'
                  '}\n' % F32_SLOTS)


def skip_tile(src):
    """The second kv tile of every query tile scores -inf: its keys drop
    out of both the softmax's sum and P·V."""
    return at(src, "scores",
              "      if (n == 1)\n"
              "        for (int i = 0; i < BK / 2; ++i) sc[i] = -INFINITY;")


def build(out, variants):
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, src in variants.items():
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
            raise SystemExit(f"flash_probe: {name} did not build:\n{report}")
        spills = {re.search(r"wgmmaILi(\d+)E", k).group(1): r.spill_stores
                  for k, r in _build.ptxas_kernels(report).items()
                  if "wgmma" in k}
        print(f"[build] {name}: spill stores by D {spills}, serialised "
              f"wgmma lines {len(_build.wgmma_serialised(report))}")
        libs[name] = ctypes.CDLL(os.path.join(out, f"{name}.so"))
    return libs


@contextlib.contextmanager
def entry(lib, fp32=False):
    """The wrapper launches ``lib``'s kernel inside the block (with
    ``fp32``, its tensor-core fp32 forward)."""
    name = "_fwd_f32_entry" if fp32 else "_entry"
    fn = getattr(lib, "flash_attention_fwd_f32" if fp32
                 else "flash_attention_fwd")
    fn.argtypes = getattr(FK, name)().argtypes
    fn.restype = ctypes.c_int
    saved = getattr(FK, name)
    setattr(FK, name, lambda: fn)
    try:
        yield
    finally:
        setattr(FK, name, saved)


def main_fp32(src, out):
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from flash_bwd_probe import kernel_us
    libs = build(out, {"kernel": src, "probed": probed_f32(src)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_khz = torch.cuda.get_device_properties(0).clock_rate
    for label, B, Hq, Hkv, S, D, W in CS.FLASH_BWD_SHAPES:
        if W is not None:
            continue
        q, k, v = CS._flash_inputs(B, Hq, Hkv, S, S, D, torch.float32,
                                   seed=4)

        def call():
            return FK.flash_attention_cuda(q, k, v, causal=True,
                                           with_lse=True)

        def simt():
            return FK.flash_attention_cuda(q, k, v, causal=True,
                                           with_lse=True, variant="simt")
        reps = 20 if S <= 128 else 5
        times = {}
        with entry(libs["kernel"], fp32=True):
            for _ in range(2):            # in turns: a, b, a, b
                times.setdefault("kernel", []).append(ms(call, reps))
                times.setdefault("simt", []).append(ms(simt, reps))
            split = kernel_us(call, r"(flash_split3|flash_fwd_f32)")
        with entry(libs["probed"], fp32=True):
            call()
            torch.cuda.synchronize()
            libs["probed"].probe_reset()
            call()
            torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * F32_SLOTS)()
        libs["probed"].probe_read(buf)
        tiles, wgs = max(buf[8], 1), max(buf[9], 1)
        rows = 128 if D <= 64 else 64
        blocks = B * Hq * -(-S // rows)
        per = (buf[5] + buf[6] + buf[7]) / wgs
        waves = blocks / sms
        print(f"[{label}] (B{B} Hq{Hq}/{Hkv} S{S} D{D}, causal, with lse) "
              f"ms {times}; by kernel (us) {split}")
        print(f"[{label}] cycles per kv tile of a consumer warpgroup "
              f"({tiles / wgs:.2f} tiles a warpgroup): "
              + ", ".join(f"{p} {buf[i] / tiles:.0f}"
                          for i, p in enumerate(F32_PHASES)))
        print(f"[{label}] per warpgroup: prologue {buf[5] / wgs:.0f}, loop "
              f"and last P V {buf[6] / wgs:.0f}, epilogue {buf[7] / wgs:.0f}"
              f" cycles; {blocks} blocks, {waves:.2f} waves of one block an "
              f"SM, cycles of a block x waves {per * waves:.0f} "
              f"({per * waves / clock_khz:.4f} ms at the "
              f"{clock_khz / 1e3:.0f} MHz the device reports)")
        del q, k, v
        torch.cuda.empty_cache()
    return 0


def ms(fn, reps=10):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "probe"),
                    help="where the copies of the source are built")
    ap.add_argument("--fp32", action="store_true",
                    help="the fp32 tensor-core forward at the fp32 "
                    "training shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA card visible", file=sys.stderr)
        return 2
    path = os.path.join(ROOT, "src", "repro_torch", "csrc",
                        "flash_attention.cu")
    with open(path) as f:
        src = f.read()
    if args.fp32:
        return main_fp32(src, args.out)
    libs = build(args.out, {"kernel": src,
                            "one_term": at(src, "lo-term", drop_next=True),
                            "skip_tile": skip_tile(src),
                            "probed": probed(src)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}")
    ok = True
    for label, (B, Hq, Hkv, S, D, W) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn((B, Hq, S, D), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, Hkv, S, D), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((B, Hkv, S, D), generator=gen,
                        device="cuda").bfloat16()

        def call():
            return FK.flash_attention_cuda(q, k, v, causal=True, window=W)
        truth = attention_ref(q.float(), k.float(), v.float(), causal=True,
                              window=W)
        gate = []
        for name in ("kernel", "one_term", "skip_tile"):
            with entry(libs[name]):
                got = call()
            excess = bf16_excess(got, truth)
            err = float((got.float() - truth).abs().max())
            passed = excess <= BF16_FLOOR
            ok &= passed == (name == "kernel")
            gate.append(f"{name} excess {excess:.4e} (max abs err {err:.4e})"
                        f" {'passes' if passed else 'fails'}")
            del got
        del truth
        print(f"[{label}] gate (floor {BF16_FLOOR:.4e}): "
              f"{'; '.join(gate)}")
        times = {}
        for rnd in range(2):          # in turns: a, b, a, b
            for name in ("kernel", "one_term"):
                with entry(libs[name]):
                    times.setdefault(name, []).append(ms(call))
        with entry(libs["probed"]):
            call()
            torch.cuda.synchronize()
            libs["probed"].probe_reset()
            call()
            torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8)()
        libs["probed"].probe_read(buf)
        tiles, wgs = max(buf[6], 1), max(buf[7], 1)
        phases = ", ".join(f"{p} {buf[i] / tiles:.0f}"
                           for i, p in enumerate(PHASES))
        print(f"[{label}] kernel {times['kernel']} ms, one-term P "
              f"{times['one_term']} ms; cycles per kv tile of a consumer "
              f"warpgroup: {phases}; prologue {buf[5] / wgs:.0f} cycles, "
              f"{tiles / wgs:.2f} tiles after the first per warpgroup")
        del q, k, v
    if not ok:
        print("flash_probe: the gate did not pass the kernel and fail both "
              "faults", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
