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
5. robust path: the same fleet under a 20% sign-flip attack, aggregated
   by ``geometric_median`` and ``trust`` (FLUDE selection) and by
   ``trimmed_mean`` (random selection), each run with its launch counts
   read across it, then a profiled short run of each;
6. card against CPU: the golden setup (N = 24, 5 rounds) on both devices,
   for FLUDE and for three robust rule / attack / policy combinations.

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
REL_TOL = 1e-5                  # of Σ_c |w_c u_cd| (fed_agg), of the
                                # distance itself (residual_norms)
ACC_TOL = 4 / 2048              # a few of the 2048 test samples
TRUST_TOL = 1e-5                # trust scores, card against CPU
MAIN_N, MAIN_PER_ROUND, MAIN_ROUNDS = 4096, 512, 6
MAIN_D = 22026                  # packed parameters of the default model
# the robust runs: (label, policy, FLConfig overrides, launches per round
# of each kernel).  The attack and the trim follow the reference's robust
# benchmark (benchmarks/bench_robust.py); the geometric median runs 6
# Weiszfeld steps, each one norm and one weighted sum, after the mean
ATTACK = dict(adversary="sign_flip",
              adversary_params=(("malicious_frac", 0.2),))
ROBUST_RUNS = [
    ("geometric_median", "flude", dict(agg_rule="geometric_median"),
     {"fed_agg": 7, "residual_norms": 6}),
    ("trust", "flude", dict(agg_rule="trust"),
     {"fed_agg": 1, "residual_norms": 1}),
    ("trimmed_mean", "random",
     dict(agg_rule="trimmed_mean", agg_rule_params=(("trim", 0.3),)),
     {"fed_agg": 0, "residual_norms": 0}),
]


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
        for line in ptxas_lines(b.report):
            log(f"[build]   {line}")


def ptxas_lines(report):
    """The ``-Xptxas -v`` lines of a build: each kernel's name, then its
    registers, shared memory and spills."""
    return [line.strip() for line in report.splitlines()
            if "entry function" in line or "registers" in line
            or "spill" in line or "smem" in line]


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
    C, D = MAIN_N, MAIN_D
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


def phase_residual_norms():
    """residual_norms against residual_norms_ref on the card; returns its
    kernels-line entry (``launches`` is filled in by the robust runs)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.robust_agg.kernel import residual_norms_cuda
    from repro_torch.kernels.robust_agg.ref import residual_norms_ref
    for line in ptxas_lines(_build.build_all(["robust_agg"])
                            ["robust_agg"].report):
        log(f"[residual_norms] ptxas: {line}")
    C, D = MAIN_N, MAIN_D
    cases = [("main", C, D), ("ragged C", 13, D), ("ragged D", C, 1),
             ("u == z", C, D)]
    max_err = 0.0
    for label, c, d in cases:
        gen = torch.Generator(device="cuda").manual_seed(c + d)
        z = torch.randn((d,), generator=gen, device="cuda")
        u = z.expand(c, d).contiguous() if label == "u == z" else \
            torch.randn((c, d), generator=gen, device="cuda")
        got = residual_norms_cuda(u, z)
        again = residual_norms_cuda(u, z)
        torch.cuda.synchronize()
        want = residual_norms_ref(u, z)
        err = (got - want).abs()
        rel = float((err / want.clamp_min(1e-30)).max())
        max_err = max(max_err, float(err.max()))
        log(f"[residual_norms] {label} ({c}, {d}): max abs err "
            f"{float(err.max()):.3e}, max err / dist {rel:.3e}, reruns "
            f"bit-identical {bool(torch.equal(got, again))}")
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"residual_norms {label}: non-finite output")
        if not bool((err <= REL_TOL * want).all()):
            raise RuntimeError(f"residual_norms {label}: error {rel:.3e} "
                               f"of the distance exceeds {REL_TOL}")
        if not torch.equal(got, again):
            raise RuntimeError(f"residual_norms {label}: two launches "
                               f"differ")

    gen = torch.Generator(device="cuda").manual_seed(1)
    u = torch.randn((C, D), generator=gen, device="cuda")
    z = torch.randn((D,), generator=gen, device="cuda")
    ms = cuda_ms(lambda: residual_norms_cuda(u, z))
    plain_ms = cuda_ms(lambda: residual_norms_ref(u, z))
    library_ms = cuda_ms(lambda: torch.cdist(
        u, z[None], compute_mode="donot_use_mm_for_euclid_dist"))
    nbytes = (C * D + D + C) * 4
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = 3 * C * D / H100_FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[residual_norms] ({C}, {D}) fp32: kernel {ms * 1e3:.1f} us, "
        f"plain {plain_ms * 1e3:.1f} us, torch.cdist {library_ms * 1e3:.1f}"
        f" us; bound {bound_ms * 1e3:.1f} us ({nbytes} bytes at 3.35 TB/s),"
        f" {bound_ms / ms:.1%} of bound, "
        f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s")
    return {"name": "residual_norms", "route": "cuda",
            "source": "src/repro_torch/csrc/robust_agg.cu",
            "replaces": "src/repro/kernels/robust_agg/kernel.py:42",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def timed_run(engine, policy, counters):
    """One run of ``engine`` with every kernel count set to 0 just before
    it and read just after; returns (History, launches, ms per round over
    rounds 1-5, peak device GiB)."""
    ticks = {}

    def progress(rnd, acc, comm, wall):
        torch.cuda.synchronize()
        ticks[rnd] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    hist = engine.run(policy, progress=progress)
    launches = {name: c.count for name, c in counters.items()}
    torch.cuda.synchronize()
    last = MAIN_ROUNDS - 1
    ms = (ticks[last] - ticks[0]) * 1e3 / last
    return hist, launches, ms, torch.cuda.max_memory_allocated() / 2**30


def check_run(label, hist, launches, per_round, num_classes):
    for name, n in launches.items():
        if n != per_round[name] * MAIN_ROUNDS:
            raise RuntimeError(f"{label}: {name} launched {n} times in "
                               f"{MAIN_ROUNDS} rounds, expected "
                               f"{per_round[name]} per round")
    acc = hist.acc[-1]
    if not (math.isfinite(acc) and acc > 1.0 / num_classes):
        raise RuntimeError(f"{label}: final accuracy {acc} not above "
                           f"chance")
    for s, r in zip(hist.selected, hist.received):
        if not 1 <= r <= s <= MAIN_PER_ROUND:
            raise RuntimeError(f"{label}: received {r}, selected {s}")


def unported_bounds():
    """The least time an H100 could take for each kernel not ported yet,
    at the shapes of ``benchmarks/bench_kernels.py``, fp32 in and out:
    the larger of bytes (each input read once, each output written once)
    over 3.35 TB/s and fp32 operations over 67 TFLOP/s.  Computed from
    the shapes, not measured.  Returns ``{name: (bound_ms, bound_by,
    bytes, flops)}``."""
    f4 = 4
    # flash attention, causal: B1 Hq8 Hkv2 S512 D64; QKᵀ and PV over the
    # causal triangle (diagonal included), 2 flops a multiply-add
    B, Hq, Hkv, S, D = 1, 8, 2, 512, 64
    flash_bytes = (2 * B * Hq * S * D + 2 * B * Hkv * S * D) * f4
    flash_flops = 2 * 2 * B * Hq * D * S * (S + 1) // 2
    # Mamba2 SSD: B1 S512 H4 P64 N64, one B/C group, chunks of 128; per
    # head and chunk: CBᵀ and M·(x·dt) over the causal triangle, the
    # inter-chunk C·stateᵀ and the state update
    B, S, H, P, N, L = 1, 512, 4, 64, 64, 128
    ssd_bytes = (B * S * H * P + B * S * H + H + 2 * B * S * N
                 + B * S * H * P + B * H * P * N) * f4
    tri = L * (L + 1) // 2
    ssd_flops = (S // L) * B * H * (2 * tri * N + 2 * tri * P
                                    + 2 * L * N * P + 2 * L * P * N)
    # WKV6: B1 H4 S256 D64; per step and head k⊗v (D²), S + u·a (2D²),
    # r·(…) (2D²), w·S + a (2D²)
    B, H, S, D = 1, 4, 256, 64
    wkv_bytes = (4 * B * H * S * D + H * D + B * H * S * D
                 + B * H * D * D) * f4
    wkv_flops = 7 * D * D * B * H * S
    out = {}
    for name, nbytes, flops in (("flash_attention", flash_bytes, flash_flops),
                                ("ssm_scan", ssd_bytes, ssd_flops),
                                ("rwkv6_scan", wkv_bytes, wkv_flops)):
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = flops / H100_FP32_FLOPS * 1e3
        out[name] = (max(bytes_ms, ops_ms),
                     "bytes" if bytes_ms >= ops_ms else "operations",
                     nbytes, flops)
    return out


def phase_main_path(counters):
    """FleetEngine.run("flude") at N = 4096 on the card; returns the
    data and each kernel's launches in the run."""
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
    hist, launches, ms, peak = timed_run(engine, "flude", counters)
    log(f"[main] selected {hist.selected}")
    log(f"[main] received {hist.received}")
    log(f"[main] acc {hist.acc}")
    log(f"[main] {1e3 / ms:.3f} rounds/s over rounds 1-{MAIN_ROUNDS - 1} "
        f"({ms:.1f} ms/round), peak device memory {peak:.2f} GiB, "
        f"launches {launches}")
    # the mean path: one fed_agg launch a round and no residual norms
    check_run("main path", hist, launches,
              {"fed_agg": 1, "residual_norms": 0}, data.num_classes)
    phase_profile(engine, "flude", "profile")
    return data, launches


def phase_robust(data, counters):
    """The robust runs of ``ROBUST_RUNS`` at the main path's size under a
    20% sign-flip attack; returns each kernel's launches per run."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.fl import FleetEngine, SimConfig
    sim = SimConfig(num_clients=MAIN_N, rounds=MAIN_ROUNDS)
    out = {}
    for label, policy, rule, per_round in ROBUST_RUNS:
        t0 = time.perf_counter()
        fl = FLConfig(num_clients=MAIN_N, clients_per_round=MAIN_PER_ROUND,
                      agg_impl="cuda", **rule, **ATTACK)
        engine = FleetEngine(data, sim, fl)
        setup = time.perf_counter() - t0
        hist, launches, ms, peak = timed_run(engine, policy, counters)
        log(f"[robust] {label} ({policy}, sign_flip 20%): engine set-up "
            f"{setup:.1f} s; selected {hist.selected}; received "
            f"{hist.received}; acc {hist.acc}")
        log(f"[robust] {label}: {ms:.1f} ms/round over rounds 1-"
            f"{MAIN_ROUNDS - 1}, peak device memory {peak:.2f} GiB, "
            f"launches {launches}")
        check_run(f"robust {label}", hist, launches, per_round,
                  data.num_classes)
        if label == "trust":
            shape = None if hist.trust is None else hist.trust.shape
            if shape != (MAIN_N,) \
                    or not math.isfinite(float(hist.trust.sum())):
                raise RuntimeError(f"robust trust: trust scores of shape "
                                   f"{shape}, expected ({MAIN_N},), finite")
            log(f"[robust] trust: min {hist.trust.min():.4f}, mean "
                f"{hist.trust.mean():.4f}")
        phase_profile(engine, policy, f"profile {label}")
        out[label] = launches
    return out


def phase_profile(engine, policy, tag, rounds=3, top=12):
    """Where a round's time goes: ``torch.profiler`` over a short
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
        engine.run(policy, rounds=rounds, diagnostics=False)
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
    log(f"[{tag}] {rounds} rounds at N={MAIN_N}: wall {wall_ms:.2f} "
        f"ms/round, device busy {busy_ms:.2f} ms/round "
        f"(idle {1 - busy_ms / wall_ms:.1%})")
    for span in spans:
        if span not in host:
            raise RuntimeError(f"{tag}: no {span!r} span recorded")
        e = host[span]
        log(f"[{tag}]   span {span:12s} host "
            f"{e.cpu_time_total / 1e3 / rounds:7.2f} ms/round, kernels "
            f"{e.device_time_total / 1e3 / rounds:7.2f} ms/round")
    ops = [e for e in host.values() if e.key not in spans
           and e.self_device_time_total > 0]
    ops += [e for k, e in device.items()
            if "fed_agg" in k or "residual_norms" in k]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / rounds
        log(f"[{tag}]   {ms:7.3f} ms/round {ms / busy_ms:6.1%} "
            f"x{e.count // rounds:<4d} {e.key[:60]}")


GOLDEN_RUNS = [
    ("flude", {}),
    ("flude", dict(agg_rule="geometric_median", **ATTACK)),
    ("flude", dict(agg_rule="trust", **ATTACK)),
    ("random", dict(agg_rule="trimmed_mean", adversary="label_flip",
                    adversary_params=(("malicious_frac", 0.2),))),
]


def phase_card_vs_cpu():
    import repro_torch.fl as F
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import federated_classification
    data = federated_classification(24, seed=2, margin=1.3, noise=1.3,
                                    n_per_client=32)
    sim = F.SimConfig(num_clients=24, rounds=5, seed=3, local_steps=4)
    for policy, extra in GOLDEN_RUNS:
        fl = FLConfig(num_clients=24, clients_per_round=8, **extra)
        tag = "golden" if not extra else \
            f"golden {policy}+{fl.agg_rule}+{fl.adversary}"
        cpu = F.run_fl(policy, data, sim, fl, device="cpu")
        gpu = F.run_fl(policy, data, sim, fl, device="cuda")
        diff = max(abs(a - b) for a, b in zip(cpu.acc, gpu.acc))
        log(f"[{tag}] cpu selected {cpu.selected} received "
            f"{cpu.received}")
        log(f"[{tag}] card acc {gpu.acc}, max |card - cpu| acc "
            f"{diff:.6f}")
        if (cpu.selected, cpu.received, cpu.wall_clock) != \
                (gpu.selected, gpu.received, gpu.wall_clock):
            raise RuntimeError(f"{tag}: card and CPU trajectories differ: "
                               f"{gpu.to_json()} vs {cpu.to_json()}")
        if diff > ACC_TOL:
            raise RuntimeError(f"{tag}: card and CPU accuracy differ by "
                               f"{diff}")
        if (cpu.trust is None) != (gpu.trust is None):
            raise RuntimeError(f"{tag}: trust scores on one device only")
        if cpu.trust is not None:
            tdiff = float(abs(cpu.trust - gpu.trust).max())
            log(f"[{tag}] max |card - cpu| trust {tdiff:.3e}")
            if tdiff > TRUST_TOL:
                raise RuntimeError(f"{tag}: trust differs by {tdiff}")


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
    from repro_torch.kernels.robust_agg import kernel as robust_kernel
    counters = {"fed_agg": fed_agg_kernel.launches,
                "residual_norms": robust_kernel.launches}

    name, count, smi = phase_device()
    phase_build()
    entries = {"fed_agg": phase_fed_agg(),
               "residual_norms": phase_residual_norms()}
    data, main = phase_main_path(counters)
    robust = phase_robust(data, counters)
    for k, entry in entries.items():
        # launches over the driven paths: the main run and the robust runs
        by_path = {"main": main[k], **{r: n[k] for r, n in robust.items()}}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    phase_card_vs_cpu()
    for k, (ms, by, nbytes, flops) in unported_bounds().items():
        log(f"[bounds] {k} (not ported; computed, not measured): "
            f"{ms * 1e3:.3f} us, {by}-bound ({nbytes} bytes, {flops} "
            f"fp32 flops)")
    print(json.dumps({"kernels": list(entries.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
