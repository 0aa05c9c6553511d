#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: the card's name, the device count and its power limit;
2. build: every CUDA kernel of the port, compiled from ``src/repro_torch/
   csrc`` by ``nvcc`` (seconds and the ``-Xptxas -v`` report);
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes and at ragged ones, bit-identical reruns, and timings
   (kernel, plain version, one PyTorch library call) beside the bound;
4. main path: ``FleetEngine.run("flude")`` at N = 4096 clients, 512 per
   round, the default classifier (D = 22,026 packed parameters), with
   every kernel's launch count read across the run, then a profiled
   short run: host and device time of the trainer, server step and eval,
   the device's idle share and the operators with the most device time;
5. card against CPU: the golden setup (N = 24, 5 rounds) on both devices.

Before the last line it prints a ``{"kernels": [...]}`` JSON line and the
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
port's sources beside it, it exits non-zero and prints no result.
"""
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
REL_TOL = 1e-5                  # of Σ_c |w_c u_cd|, per output
ACC_TOL = 4 / 2048              # a few of the 2048 test samples
MAIN_N, MAIN_PER_ROUND, MAIN_ROUNDS = 4096, 512, 6


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps=100, warmup=10):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; nvidia-smi: {smi}")
    return name, count, smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    builds = _build.build_all()
    log(f"[build] {len(builds)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, b in builds.items():
        log(f"[build] {name}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        for line in b.report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")


def _agg_inputs(C, D, seed, zero_weights=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((C, D), generator=gen, device="cuda")
    w = torch.rand((C,), generator=gen, device="cuda")
    w = torch.zeros_like(w) if zero_weights else w / w.sum()
    return u, w


def phase_fed_agg():
    """fed_agg against fed_agg_ref on the card; returns its kernels-line
    entry (``launches`` is filled in by the main path)."""
    from repro_torch.kernels.fed_agg.kernel import fed_agg_cuda
    from repro_torch.kernels.fed_agg.ref import fed_agg_ref
    C, D = MAIN_N, 22026
    cases = [("main", C, D, False), ("ragged C", 13, D, False),
             ("ragged D", C, 1, False), ("zero weights", C, D, True)]
    max_err = 0.0
    for label, c, d, zero in cases:
        u, w = _agg_inputs(c, d, seed=c + d, zero_weights=zero)
        got = fed_agg_cuda(u, w)
        again = fed_agg_cuda(u, w)
        torch.cuda.synchronize()
        want = fed_agg_ref(u, w)
        scale = fed_agg_ref(u.abs(), w.abs())
        err = (got - want).abs()
        rel = float((err / scale.clamp_min(1e-30)).max())
        max_err = max(max_err, float(err.max()))
        log(f"[fed_agg] {label} ({c}, {d}): max abs err {float(err.max()):.3e}"
            f", max err / sum|w*u| {rel:.3e}, reruns bit-identical "
            f"{bool(torch.equal(got, again))}")
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"fed_agg {label}: non-finite output")
        if not bool((err <= REL_TOL * scale + 1e-30).all()):
            raise RuntimeError(f"fed_agg {label}: error {rel:.3e} of "
                               f"sum|w*u| exceeds {REL_TOL}")
        if not torch.equal(got, again):
            raise RuntimeError(f"fed_agg {label}: two launches differ")
        if zero and bool((got != 0).any()):
            raise RuntimeError("fed_agg: all-zero weights gave non-zeros")

    u, w = _agg_inputs(C, D, seed=1)
    ms = cuda_ms(lambda: fed_agg_cuda(u, w))
    plain_ms = cuda_ms(lambda: fed_agg_ref(u, w))
    library_ms = cuda_ms(lambda: torch.mv(u.t(), w))
    nbytes = (C * D + C + D) * 4
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = 2 * C * D / H100_FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[fed_agg] ({C}, {D}) fp32: kernel {ms * 1e3:.1f} us, plain "
        f"{plain_ms * 1e3:.1f} us, torch.mv {library_ms * 1e3:.1f} us; "
        f"bound {bound_ms * 1e3:.1f} us ({nbytes} bytes at 3.35 TB/s), "
        f"{bound_ms / ms:.1%} of bound, "
        f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s")
    return {"name": "fed_agg", "route": "cuda",
            "source": "src/repro_torch/csrc/fed_agg.cu",
            "replaces": "src/repro/kernels/fed_agg/kernel.py:37",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def phase_main_path(counters):
    """FleetEngine.run("flude") at N = 4096 on the card; returns each
    kernel's launches in the run."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import federated_classification
    from repro_torch.fl import FleetEngine, SimConfig
    t0 = time.perf_counter()
    data = federated_classification(MAIN_N, seed=8)
    sim = SimConfig(num_clients=MAIN_N, rounds=MAIN_ROUNDS)
    fl = FLConfig(num_clients=MAIN_N, clients_per_round=MAIN_PER_ROUND,
                  agg_impl="cuda")
    engine = FleetEngine(data, sim, fl)
    log(f"[main] data + engine set-up {time.perf_counter() - t0:.1f} s "
        f"(N={MAIN_N}, {MAIN_PER_ROUND} per round, local_steps="
        f"{sim.local_steps}, hidden={sim.model_hidden}, depth="
        f"{sim.model_depth})")
    ticks = {}

    def progress(rnd, acc, comm, wall):
        torch.cuda.synchronize()
        ticks[rnd] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    hist = engine.run("flude", progress=progress)
    launches = {name: c.count for name, c in counters.items()}
    torch.cuda.synchronize()
    last = MAIN_ROUNDS - 1
    rps = last / (ticks[last] - ticks[0])
    log(f"[main] selected {hist.selected}")
    log(f"[main] received {hist.received}")
    log(f"[main] acc {hist.acc}")
    log(f"[main] {rps:.3f} rounds/s over rounds 1-{last} "
        f"({1e3 / rps:.1f} ms/round), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches}")
    for name, n in launches.items():
        if n != MAIN_ROUNDS:
            raise RuntimeError(f"{name}: {n} launches in {MAIN_ROUNDS} "
                               f"rounds, expected one per round")
    acc = hist.acc[-1]
    if not (math.isfinite(acc) and acc > 1.0 / data.num_classes):
        raise RuntimeError(f"main path: final accuracy {acc} not above "
                           f"chance")
    for s, r in zip(hist.selected, hist.received):
        if not 1 <= r <= s <= MAIN_PER_ROUND:
            raise RuntimeError(f"main path: received {r}, selected {s}")
    phase_profile(engine)
    return launches


def phase_profile(engine, rounds=3, top=12):
    """Where a main-path round's time goes: ``torch.profiler`` over a short
    run after the timed one, with spans around the engine's trainer,
    server step and eval (the rest of a round is planning and the host
    loop).  Prints host and device time per span, the device's busy share
    of the wall clock and the operators with the most device time.  The
    spans wrap this engine's instance attributes; it is not used after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def spanned(name, fn):
        def run(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return run

    engine._trainer = spanned("trainer", engine.trainer)
    engine._server_steps = {k: spanned("server_step", v)
                            for k, v in engine._server_steps.items()}
    engine._accuracy = spanned("eval", engine._accuracy)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run("flude", rounds=rounds, diagnostics=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    spans = ("trainer", "server_step", "eval")
    events = prof.key_averages()
    host = {e.key: e for e in events if e.device_type == DeviceType.CPU}
    # CUDA-side events are the kernels plus one annotation per span
    # (the span's extent on the device timeline), kept out of the sum
    device = {e.key: e for e in events if e.device_type == DeviceType.CUDA}
    busy_ms = sum(e.self_device_time_total for k, e in device.items()
                  if k not in spans) / 1e3 / rounds
    log(f"[profile] {rounds} rounds at N={MAIN_N}: wall {wall_ms:.2f} "
        f"ms/round, device busy {busy_ms:.2f} ms/round "
        f"(idle {1 - busy_ms / wall_ms:.1%})")
    for span in spans:
        if span not in host:
            raise RuntimeError(f"profile: no {span!r} span recorded")
        e = host[span]
        log(f"[profile]   span {span:12s} host "
            f"{e.cpu_time_total / 1e3 / rounds:7.2f} ms/round, kernels "
            f"{e.device_time_total / 1e3 / rounds:7.2f} ms/round")
    ops = [e for e in host.values() if e.key not in spans
           and e.self_device_time_total > 0]
    ops += [e for k, e in device.items() if "fed_agg" in k]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / rounds
        log(f"[profile]   {ms:7.3f} ms/round {ms / busy_ms:6.1%} "
            f"x{e.count // rounds:<4d} {e.key[:60]}")


def phase_card_vs_cpu():
    import repro_torch.fl as F
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import federated_classification
    data = federated_classification(24, seed=2, margin=1.3, noise=1.3,
                                    n_per_client=32)
    sim = F.SimConfig(num_clients=24, rounds=5, seed=3, local_steps=4)
    fl = FLConfig(num_clients=24, clients_per_round=8)
    cpu = F.run_fl("flude", data, sim, fl, device="cpu")
    gpu = F.run_fl("flude", data, sim, fl, device="cuda")
    diff = max(abs(a - b) for a, b in zip(cpu.acc, gpu.acc))
    log(f"[golden] cpu selected {cpu.selected} received {cpu.received}")
    log(f"[golden] card acc {gpu.acc}, max |card - cpu| acc {diff:.6f}")
    if (cpu.selected, cpu.received, cpu.wall_clock) != \
            (gpu.selected, gpu.received, gpu.wall_clock):
        raise RuntimeError("card and CPU trajectories differ: "
                           f"{gpu.to_json()} vs {cpu.to_json()}")
    if diff > ACC_TOL:
        raise RuntimeError(f"card and CPU accuracy differ by {diff}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.fed_agg import kernel as fed_agg_kernel

    name, count, smi = phase_device()
    phase_build()
    entries = {"fed_agg": phase_fed_agg()}
    launches = phase_main_path({"fed_agg": fed_agg_kernel.launches})
    for k, n in launches.items():
        entries[k]["launches"] = n
    phase_card_vs_cpu()
    print(json.dumps({"kernels": list(entries.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
