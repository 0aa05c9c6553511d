#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: the card's name, the device count and its power limit, and
   one SHA-256 of the tree the run executes (``[provenance]``);
2. build: every CUDA kernel of the port, compiled from ``src/repro_torch/
   csrc`` by ``nvcc`` (seconds and the ``-Xptxas -v`` report; each
   flash_attention variant's registers, shared memory and spills, and a
   failure on serialised wgmma, on a spill of the bf16 wgmma variant at
   D 64, 80 or 128 and on one of the fp32 ``flash_fwd_f32`` at D 32 to
   128; each scan variant's registers and spills, and a
   failure on a spill of ``ssd_bwd_mma`` or ``ssd_bwd_mma_f32`` at P = N
   = 64 and on one of more than 64 bytes of ``ssd_fwd_mma_f32`` there);
3. kernels: each kernel against its plain PyTorch version at the main
   paths' shapes and at ragged ones, bit-identical reruns, and timings
   (kernel, plain version, one PyTorch library call, in turns) beside
   the bound: ``fed_agg`` (odd D, each D mod 4, misaligned rows),
   ``residual_norms``, ``flash_attention`` (which variant ran: the
   tensor-core ``wgmma_f32`` for fp32, also run through ``simt`` by name,
   wgmma for bf16, the latter held to its bf16-P plain version)
   at the three serve prefills' shapes (SDPA as the library call) and
   once at Qwen2-7B's through the model-layout adapter on strided views,
   and ``ssm_scan`` and ``rwkv6_scan`` at the zamba2-1.2b and rwkv6-7b
   prefill shapes and ragged ones, each variant held to the per-step
   oracle (bf16: the tensor-core ``ssd_fwd_mma`` / ``wkv_fwd_mma``; fp32:
   ``ssd_fwd_mma_f32`` on the tensor cores and ``ssd_fwd_simt`` by name,
   the SIMT ``wkv_fwd_simt``), the bf16 ones timed there (no library
   call computes either);
4. main path: ``FleetEngine.run("flude")`` at N = 4096 clients, 512 per
   round, the default classifier (D = 22,026 packed parameters), with
   every kernel's launch count read across the run, then a profiled
   short run: host and device time of the trainer, server step and eval,
   the device's idle share and the operators with the most device time;
5. robust path: the same fleet under a 20% sign-flip attack, aggregated
   by ``geometric_median`` and ``trust`` (FLUDE selection) and by
   ``trimmed_mean`` (random selection), each run with its launch counts
   read across it, then a profiled short run of each;
5b. dynamics: the device round loop on the same fleet — FLUDE under the
   ``churn`` (markov), ``diurnal`` (sessions) and ``flash-crowd`` (trace)
   scenarios and under ``bernoulli`` at pipeline depths 1 and 2 (the two
   held to identical History rows), each held to one ``fed_agg`` launch a
   round; ``sign-flip-20`` under ``geometric_median`` held to that rule's
   launches; a depth-2 run under ``torch.cuda`` sync debug mode "error"
   (only the round ledger's resolve and the run-end read-back may wait
   for the card); N = 24 under churn on the card against the CPU with the
   same uniforms; a profiled short run of the depth-2 engine;
5c. cohorts (``[cohort]``, ``[cohort 1M]``), then Thompson selection,
   telemetry and the invariant checks on the device loop at N = 4096:
   ``[thompson]`` ("mean" and "thompson" in turns with the CUDA sampler,
   |S| = min(X, |online|), card = CPU with handed-in draws),
   ``[telemetry]`` (off and "full" in turns, full scan and X = 512: rows
   identical, ``update_norm``'s one ``fed_agg`` and two
   ``residual_norms`` launches a round; a no-sync "full" run; card = CPU
   for ``History.metrics``), ``[debug_checks]`` (checked and unchecked in
   turns, a no-sync checked run with one guard read a round through
   ``host_readback``, the guard on a card NaN).  Every profile is a
   ``repro_torch.obs.Telemetry`` session: the port's span names, host
   time from its tracer, device time from its profiler window;
6. serve: ``qwen2-7b`` (batch 4, prompt 2048, 32 decode steps),
   ``h2o-danube-1.8b`` (batch 2, prompt 6144 past its 4096 window, 16
   steps), ``zamba2-1.2b`` (batch 4, prompt 4096, 32 steps: 38 Mamba2
   layers and 7 shared-attention applications) and ``rwkv6-7b`` (batch
   4, prompt 2048, 32 steps) at full width and depth in bf16 through
   ``serve()``, launch counts read across each run (every flash and scan
   launch of the bf16 prefill a tensor-core variant), the prefill checked
   against the plain attention and scans, then a profiled prefill + 4
   decode steps;
6b. training (``python -m repro_torch.launch.train``, fp32 at full
   width): ``[flash_bwd]`` the backward kernel against autograd through
   the plain attention at the training shapes (flude-paper, 100m at S
   128 and at S 2048 with and without a window of 1024) and ragged ones,
   dq, dk and dv within 1e-4 of max(1, max |g|), reruns bit-identical,
   timed beside SDPA's fp32 backward, the plain backward and the bound,
   and the fp32 kernels' and the plain fp32 attention's distances from a
   float64 truth (out, lse, dq, dk, dv) at zamba2's training and serve
   shapes; ``[flash_bwd bf16]`` the backward on bf16 inputs after the
   wgmma forward with its lse (the lse held to the SIMT forward's), the
   tensor-core kernels (``wgmma_bf16``) and the SIMT ones on the same
   values (``simt_bf16``) each against autograd through the plain
   attention in fp32 on the same values, each gradient within one bf16
   ulp plus 1e-4 of max(1, max |g|) (``ref.bf16_grad_gate``), at
   zamba2-1.2b's training shape, Danube's and Qwen2's heads and ragged
   ones, the two variants timed in turns beside SDPA's bf16 backward,
   the plain backward and the bf16 bound;
   ``[ssm_scan_bwd]`` and ``[rwkv6_scan_bwd]`` the scans' backward
   kernels against autograd through their per-step oracles at the 10m
   and 100m training shapes, ragged S, states set and null, P 32 / N 16
   and D 32, and one full-width zamba2-1.2b / rwkv6-7b layer (per
   gradient within 2e-4 / 1e-4 of max(1, max |g|) and 1e-3 of its own
   max |g|), reruns bit-identical, timed beside the plain autograd
   backward and the bound (the SSD's default on fp32, ``mma_f32`` on the
   tensor cores, and ``ssd_bwd_simt`` by name, both held to the oracle
   and timed in turns against the tensor-core floor and the fp32 bound;
   each gradient of ``mma_f32`` within 2x of the SIMT kernel's distance
   from a float64 truth, ``ssd_f64_distances``); ``[ssm_scan_bwd
   bf16]`` the SSD backward on
   bf16 x, B and C the same way (one bf16 ulp plus 2e-4), the
   tensor-core kernel (``mma_bf16``) and the SIMT one on the same values
   (``simt_bf16``), at zamba2-1.2b's training shape and full layer and
   ragged ones (every (P, N), groups, states, S 1, several heads a
   block), the two timed in turns; ``[flash_fwd fp32]`` the fp32 flash
   forward with its lse (``wgmma_f32``) at the fp32 training shapes in
   turns with SDPA's and with ``flash_fwd_simt`` by name; ``[scan_fwd
   fp32]`` the fp32 SSD forward (``mma_f32``) in turns with
   ``ssd_fwd_simt`` by name at zamba2 100m's and 10m's training shapes
   and one zamba2-1.2b layer, against ``ssd_fwd_bounds``, and y and the
   final state of both held to a float64 truth (``mma_f32`` within 2x of
   the SIMT kernel's distance, ``ssd_fwd_f64_distances``), and the fp32
   WKV forward at rwkv6 100m's;
   ``[train flude-paper]``, ``[train 100m]``, ``[train 100m S2048]``,
   ``[train zamba2 10m]``, ``[train zamba2 100m]``, ``[train rwkv6
   10m]`` and ``[train rwkv6 100m]``: the driver's rounds with every
   kernel count read across the run (each block's kernel forward twice a
   step under remat, its backward once: ``train_step_launches``), a loss
   that falls from round 0, ms/round, tok/s and peak memory;
   ``[train 100m grads]``, ``[train grads zamba2 full]`` (zamba2-1.2b,
   full width and depth, 2 x 1024) and ``[train grads rwkv6 full]``
   (rwkv6-7b, full width, 4 layers, 1 x 1024): one step's gradients of
   ``Model.loss`` through the kernels against the plain attention and
   scans, on the card; a profiled 100m window (flash forward and
   backward against cuBLAS and the optimizer's passes, idle share);
   ``[train zamba2-1.2b bf16]`` (no ``--scale``: 38 Mamba2 layers and 7
   shared-attention applications at full width in bf16, fp32 moments,
   the bf16 kernels' launches a step exact) and ``[train grads zamba2
   full bf16]`` (one step three ways: the kernels in bf16, the plain path
   in bf16, the per-step plain path in fp32 as the oracle; per leaf the
   kernels no further from the oracle than 2x the bf16 plain path) and
   ``[train grads zamba2 shallow bf16]`` (the same at full width cut to
   one Mamba2 layer and one shared-attention application, per leaf
   within 5% of the oracle's own max |g| and L2 norm, the kernels and the
   bf16 plain path alike);
   ``[train card vs CPU]`` (4-silo runs of flude-paper and of both
   recurrent stacks at --scale 10m, trajectories identical, loss within
   1e-4); ``[serve ckpt]`` the 100m checkpoint the training run saved,
   restored bit for bit and served, and a small one served on both
   devices: logits teacher-forced on the CPU's ids held together, ids
   compared with each step's top-2 margin, each checkpoint's SHA-256
   logged; ``[poison]`` every output and workspace the kernel wrappers
   allocate filled with NaN (``_build.poisoned``): the fp32 flash
   forward at three ragged shapes and the fp32 SSD forward at two,
   ``tools/bwd_check.py``,
   the bf16 SSD backward at a ragged shape and ``[serve ckpt]`` again, at
   their gates;
7. card against CPU: the golden FL setup (N = 24, 5 rounds) for FLUDE
   and three robust rule / attack / policy combinations, and the four
   reduced serve configs in fp32.

Before the last line it prints a ``{"kernels": [...]}`` JSON line and the
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
port's sources beside it, it exits non-zero and prints no result.
"""
import contextlib
import dataclasses
import gc
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
H100_L2_BYTES = 50 * 2**20      # L2 cache, H100 SXM
H100_BF16_FLOPS = 989.4e12      # bf16 tensor cores, dense
REL_TOL = 1e-5                  # of Σ_c |w_c u_cd| (fed_agg), of the
                                # distance itself (residual_norms)
ACC_TOL = 4 / 2048              # a few of the 2048 test samples
TRUST_TOL = 1e-5                # trust scores, card against CPU
MAIN_N, MAIN_PER_ROUND, MAIN_ROUNDS = 4096, 512, 6
MAIN_D = 22026                  # packed parameters of the default model
# compact cohorts: X rows a round at the main path's fleet, and the
# reference's million-client smoke (benchmarks/bench_engine.py:679-700):
# the default classifier on dim-4, 2-class data packs D = 17,410
COHORT_X = 512
N_1M, D_1M, ROUNDS_1M = 1_000_000, 17410, 3
# flash_attention against attention_ref.  fp32 (flash_fwd_f32, and
# flash_fwd_simt by name): both compute to fp32 accuracy (the tensor-core
# variant in three bf16 terms a factor) and differ in summation order;
# within 1e-5 of max(1, |o|).  bf16 (flash_fwd_wgmma) carries P to the tensor cores in two bf16
# terms (16 significant bits) and rounds its output to bf16 once, so it
# is held to the fp32 truth, attention_ref on the same bf16 inputs with
# fp32 P and an fp32 output, element by element: |o - truth| within one
# bf16 ulp of |truth| plus ref.BF16_FLOOR (2^-12) of the row's largest
# |truth| (ref.bf16_excess <= ref.BF16_FLOOR).  Stated in PERF.md before
# the chip run that read it, in place of a tensor-wide 2x the
# one-term-P plain version's error + 2^-7 max |o|, which let a kernel
# tens of percent wrong on late causal rows pass; the floor lies between
# the kernel's reading and that of a kernel with P in one term
# (tools/flash_probe.py)
FLASH_F32_TOL = 1e-5
# the serve prefills' attention: (B, Hq, Hkv, Sq, Sk, D, dtype, q_offset,
# causal, window)
FLASH_QWEN2 = (4, 28, 4, 2048, 2048, 128, torch.bfloat16, 0, True, None)
FLASH_DANUBE = (2, 32, 8, 6144, 6144, 80, torch.bfloat16, 0, True, 4096)
FLASH_ZAMBA2 = (4, 32, 32, 4096, 4096, 64, torch.bfloat16, 0, True, None)
# the SSD and WKV scans at the serve prefills' shapes: (B, S, H, P, N,
# G, dtype of x/B/C) and (B, S, H, D, dtype of r/k/v); dt and logw fp32
SSM_ZAMBA2 = (4, 4096, 64, 64, 64, 1, torch.bfloat16)
WKV_RWKV6 = (4, 2048, 64, 64, torch.bfloat16)
# ssm_scan (the chunked form at chunk 64) against ssm_scan_ref (the
# per-step recurrence), both fp32 inside: exp of a within-chunk cumsum
# against a product of per-step exps, 2.5e-5 of max(1, |y|) measured on
# the CPU at S 4096, P = N = 64 (float64 truth); stated before the first
# run: within 2e-4 of max(1, |y|), for both variants (the bf16 one
# carries its fp32 factors as two bf16 terms, 2^-18 each).
# rwkv6_scan's SIMT variant runs the oracle's own per-step recurrence in
# another summation order (1e-6 of max(1, |y|) between fp32 and fp64 on
# the CPU), its bf16 variant the chunked form with fp32 operands as three
# bf16 terms: within 2e-5
SSM_REL = 2e-4
WKV_REL = 2e-5
# the serve runs: (path label, arch, batch, prompt, decode steps,
# parameters, launches per prefill of each kernel of the path (flash one
# per attention layer or shared-attention application, the scans one per
# Mamba2 or RWKV layer), the dtype the prefill is held to the plain path
# in)
SERVE_RUNS = [
    ("serve_qwen2", "qwen2-7b", 4, 2048, 32, 7_615_616_512,
     {"flash_attention": 28}, "bf16"),
    ("serve_danube", "h2o-danube-1.8b", 2, 6144, 16, 1_831_201_280,
     {"flash_attention": 24}, "bf16"),
    ("serve_zamba2", "zamba2-1.2b", 4, 4096, 32, 1_153_696_640,
     {"ssm_scan": 38, "flash_attention": 7}, "fp32"),
    ("serve_rwkv6", "rwkv6-7b", 4, 2048, 32, 7_618_838_528,
     {"rwkv6_scan": 32}, "fp32"),
]
# bf16 prefill logits of the dense models, the kernel against the plain
# attention: the two round the fp32 results to bf16 at other places (a
# bf16 ulp is 2^-8 relative) and 24-28 residual layers carry it; stated
# before the first run of PR 13: within 0.1 of max(1, |logit|)
SERVE_BF16_TOL = 0.1
# The recurrent stacks amplify those bf16 roundings (on the H100 the bf16
# kernel path is 0.76 and 0.97 of max(1, |logit|) from the bf16 plain
# path at full depth, with other first tokens).  Their kernels are
# held to the plain path in fp32 at full width and depth: the scans
# differ by up to 2e-4 of max(1, |y|) per layer in fp32 (the chunked
# forms' exponent sums); stated before the first such run: within 5e-3
# of max(1, |logit|), the same first token
SERVE_F32_FULL_TOL = 5e-3
# and the timed bf16 kernel path is held to that fp32 plain prefill: its
# gap there at most twice the bf16 plain path's own gap to it.  Both
# round the same bf16 weights and activations and differ only in the
# scans' fp32 summation order and where y is rounded, so their gaps
# should be alike; stated before the first such run
SERVE_BF16_RATIO = 2.0
SERVE_F32_TOL = 1e-4            # fp32 logits, card against CPU
# the flash backward (flash_attention_bwd_cuda) against autograd through
# attention_ref, both fp32, other summation orders over up to Sk keys and
# G heads: dq, dk and dv each within 1e-4 of max(1, max |g|) of its own
# tensor (stated in PERF.md before its first run on the card)
FLASH_BWD_TOL = 1e-4
# the training shapes of the backward: (label, B, Hq, Hkv, S, D, window),
# causal: flude-paper (8 silos x 4, S 128), 100m (the same batch), 100m
# at S 2048 (8 x 1), with and without a window of 1024
FLASH_BWD_SHAPES = [
    ("flude-paper", 32, 8, 4, 128, 32, None),
    ("100m", 32, 12, 4, 128, 64, None),
    ("100m S2048", 8, 12, 4, 2048, 64, None),
    ("100m S2048 window 1024", 8, 12, 4, 2048, 64, 1024),
]
# the fp32 flash kernels (the wgmma_f32 forward with its lse and
# backward, and the SIMT ones by name) and the plain fp32 attention, each
# held to a float64 truth on the same fp32 inputs (attention_ref and its
# autograd in float64 on the card): zamba2-1.2b's training shape and its
# serve shape at B 1, and 100m's training shape (GQA), causal.  The
# default forward's out and lse and the backward's dq, dk and dv may lie
# no more than 2x as far as the plain fp32 attention's (stated in
# PERF.md before the first run).  (label, B, Hq, Hkv, S, D)
FLASH_F64_SHAPES = [
    ("zamba2 training", 32, 32, 32, 128, 64),
    ("zamba2 serve B 1", 1, 32, 32, 4096, 64),
    ("100m training", 32, 12, 4, 128, 64),
]
# the fp32 tensor-core floor of the flash backward's counted work: six
# bf16 products (three terms a factor) for one fp32-accurate one, 989 / 6
# TFLOP/s (495 / 3 for 3xTF32 comes to the same)
H100_F32_TC_FLOPS = H100_BF16_FLOPS / 6
# the scans' backward kernels (ssm_scan_bwd_cuda, rwkv6_scan_bwd_cuda)
# against autograd through the per-step oracles, fp32 on the card, per
# gradient tensor: the SSD within SSM_BWD_TOL of max(1, max |g|) (the
# forward's SSM_REL: the chunked form's exp of within-chunk cumsums
# against a product of per-step exps; the fp32 mirror read 2.4e-6 to
# 9e-6 at S 1024-4096 on the CPU), the WKV within WKV_BWD_TOL (the
# per-step form in another order; its dlogw identity cancels to 1.6e-6
# of max |dlogw| at S 2048 on the CPU); both also within
# GRAD_ATTN_REL_TOL of the tensor's own max |g|, which a zero or lost
# gradient fails.  Stated in PERF.md before the first run on the card
SSM_BWD_TOL = 2e-4
WKV_BWD_TOL = 1e-4
# (label, B, S, H, P, N, G, h0, dh_f): the 10m and 100m training shapes
# (zamba2 at --scale: d_inner 2 x d_model, heads of 64, N 64, one group),
# ragged S, states set and null, P 32 / N 16, and one full-width
# zamba2-1.2b layer
SSD_BWD_CASES = [
    ("10m training", 32, 128, 12, 64, 64, 1, False, False),
    ("100m training", 32, 128, 24, 64, 64, 1, False, False),
    ("ragged S 1000, G 2, P 32 / N 16, h0, dh_f", 2, 1000, 4, 32, 16, 2,
     True, True),
    ("ragged S 77, P 64 / N 16, G 4, h0", 1, 77, 8, 64, 16, 4, True, False),
    ("S 1, P 32 / N 64, h0, dh_f", 3, 1, 2, 32, 64, 1, True, True),
    ("zamba2-1.2b layer", 4, 4096, 64, 64, 64, 1, False, False),
]
# The fp32 SSD backward's default (mma_f32, the tensor cores with every
# factor in bf16 terms) against ssd_bwd_simt, each held to a float64 truth
# on the same fp32 inputs (autograd through the per-step oracle in
# float64): every gradient of the default no more than SSD_F64_RATIO
# times as far as the SIMT kernel's (stated in PERF.md before the first
# run; the plain fp32 autograd logged beside).  The 100m training shape,
# one full zamba2-1.2b layer, and ragged S with G > 1 and both states
SSD_F64_RATIO = 2.0
SSD_F64_CASES = [
    ("100m training", 32, 128, 24, 64, 64, 1, False, False),
    ("zamba2-1.2b layer", 4, 4096, 64, 64, 64, 1, False, False),
    ("ragged S 300, G 2, h0, dh_f", 4, 300, 8, 64, 64, 2, True, True),
]
# The fp32 SSD forward's default (mma_f32) against ssd_fwd_simt, each held
# to a float64 truth on the same fp32 inputs (the per-step oracle in
# float64): y and the final state of the default no more than
# SSD_F64_RATIO times as far as the SIMT kernel's (stated in PERF.md
# before the first run; the plain fp32 per-step oracle logged beside).
# (label, B, S, H, P, N, G, h0): the 100m and 10m training shapes, one
# full zamba2-1.2b layer, ragged S with G > 1 and h0, and S 1
SSD_FWD_F64_CASES = [
    ("100m training", 32, 128, 24, 64, 64, 1, False),
    ("10m training", 32, 128, 12, 64, 64, 1, False),
    ("zamba2-1.2b layer", 4, 4096, 64, 64, 64, 1, False),
    ("ragged S 300, G 2, h0", 4, 300, 8, 64, 64, 2, True),
    ("S 1, h0", 3, 1, 8, 64, 64, 1, True),
]
# ssd_fwd_mma_f32 runs three blocks an SM, at most 168 registers a thread:
# at P = N = 64 ptxas spills 16 bytes (PERF.md); a build of it that held
# the next chunk's rows in registers spilled 524 bytes and ran 1.26x as
# long at zamba2 100m's training shape (tools/scan_probe.py --fp32): a
# spill past this many bytes fails the build phase
SSD_FWD_SPILL_MAX = 64
# (label, B, S, H, D, s0, dS_f): rwkv6 at --scale (heads of 64), ragged
# S, states, D 32, one full-width rwkv6-7b layer
WKV_BWD_CASES = [
    ("10m training", 32, 128, 6, 64, False, False),
    ("100m training", 32, 128, 12, 64, False, False),
    ("ragged S 1000, D 32, s0, dS_f", 2, 1000, 8, 32, True, True),
    ("ragged S 77, D 32, s0", 1, 77, 3, 32, True, False),
    ("S 1, D 64, s0, dS_f", 3, 1, 2, 64, True, True),
    ("rwkv6-7b layer", 4, 2048, 64, 64, False, False),
]
# the training runs of launch.train: (path label, arguments, rounds).
# The loss must fall: the mean of the last quarter of the rounds' losses
# below round 0's
TRAIN_RUNS = [
    ("train flude-paper", [], 40),
    ("train 100m", ["--scale", "100m"], 30),
    ("train 100m S2048", ["--scale", "100m", "--seq-len", "2048",
                          "--batch-per-silo", "1"], 16),
    ("train zamba2 10m", ["--arch", "zamba2-1.2b", "--scale", "10m"], 30),
    ("train zamba2 100m", ["--arch", "zamba2-1.2b", "--scale", "100m"], 30),
    ("train rwkv6 10m", ["--arch", "rwkv6-7b", "--scale", "10m"], 30),
    ("train rwkv6 100m", ["--arch", "rwkv6-7b", "--scale", "100m"], 30),
]
# one step's gradients of Model.loss at full width, the kernels against
# the plain path, fp32 on the card: (label, arch, layers or None for the
# full depth, B, S, the leaves also held to GRAD_ATTN_REL_TOL of their own
# max |g|).  rwkv6-7b's depth is cut to 4: two fp32 gradient sets of its
# 7.6B parameters do not fit in 80 GB
TRAIN_GRADS_FULL = [
    ("train grads zamba2 full", "zamba2-1.2b", None, 2, 1024,
     ("a_log", "dt_bias", "w_in")),
    ("train grads rwkv6 full", "rwkv6-7b", 4, 1, 1024,
     ("w_r", "w_k", "w_v", "w0", "w_lora_a", "w_lora_b", "u_bonus")),
]
TRAIN_F32_TOL = 1e-4            # the driver's loss, card against CPU
# The bf16 backward kernels (flash's on the tensor cores and the SIMT
# ones on bf16 values widened as they load, each gradient rounded once
# to bf16) against autograd through the plain version in fp32 on the
# same bf16 values, upcast, element by element: |g - truth| within one
# bf16 ulp of the truth (ref.bf16_ulp) plus the fp32 kernel's gate
# (FLASH_BWD_TOL, SSM_BWD_TOL) of max(1, max |truth|); that excess beyond
# one ulp also within ref.BF16_BWD_OWN_TOL (1e-3) of the tensor's own max
# |truth|, which a zero gradient fails; fp32 outputs (dA, dh0) without
# the ulp (ref.bf16_grad_gate, which the tests share).  Stated here before
# the first run on the card
# flash_fwd_wgmma's lse against flash_fwd_simt's on the same bf16 values
# upcast, row by row: both sum l from the fp32 P (ex2.approx against expf,
# the tensor cores' order against FMAs): within 1e-5 of max(1, |lse|).
# Stated here before the first run on the card
FLASH_LSE_TOL = 1e-5
# the bf16 backwards' shapes: (label, B, Hq, Hkv, S, D, window), causal:
# zamba2-1.2b's training step (8 silos x 4, S 128), h2o-danube-1.8b's
# heads past its window, qwen2-7b's heads
FLASH_BWD_BF16_SHAPES = [
    ("zamba2-1.2b training", 32, 32, 32, 128, 64, None),
    ("danube heads S 6144", 1, 32, 8, 6144, 80, 4096),
    ("qwen2 heads S 2048", 1, 28, 4, 2048, 128, None),
]
# (label, B, S, H, P, N, G, h0, dh_f, dt dtype), x, B and C bf16; the
# mma kernel walks heads_per_block heads a block: 8 at the training shape,
# 4 at "G 2, four heads a block", 1 elsewhere
SSD_BWD_BF16_CASES = [
    ("zamba2-1.2b training", 32, 128, 64, 64, 64, 1, False, False,
     torch.float32),
    ("ragged S 1000, G 2, P 32 / N 16, h0, dh_f, bf16 dt", 2, 1000, 4, 32,
     16, 2, True, True, torch.bfloat16),
    ("ragged S 77, P 64 / N 16, G 4, h0", 1, 77, 8, 64, 16, 4, True, False,
     torch.float32),
    ("S 1, P 32 / N 64, h0, dh_f, bf16 dt", 3, 1, 2, 32, 64, 1, True, True,
     torch.bfloat16),
    ("ragged S 300, G 2, four heads a block, h0, dh_f", 16, 300, 64, 64, 64,
     2, True, True, torch.float32),
    ("zamba2-1.2b layer", 4, 4096, 64, 64, 64, 1, False, False,
     torch.float32),
]
# zamba2-1.2b in its own bf16 (no --scale): 38 Mamba2 layers and 7
# shared-attention applications at full width, fp32 Adam moments, 8 silos
# x 4 x 128: (path label, arguments, rounds).  At launch.train's default
# lr 1e-3 the 1.15B stack spikes once warm (11.76 at round 23) and its
# last quarter stays above round 0, through the kernels and through the
# plain path alike (PERF.md section 6); at 3e-4 the loss falls
TRAIN_BF16 = ("train zamba2-1.2b bf16", ["--arch", "zamba2-1.2b", "--lr",
                                         "3e-4"], 40)
# one step's gradients at full width and depth in bf16, 2 x 1024, three
# ways: the kernels in bf16, the plain path in bf16 and the per-step
# oracles in fp32 on the same weights upcast.  Per leaf, the kernel path
# no further from the fp32 oracle than BF16_GRAD_RATIO times the bf16
# plain path is (the serve gates' rule, PERF.md section 2)
TRAIN_GRADS_BF16 = ("train grads zamba2 full bf16", "zamba2-1.2b", 2, 1024,
                    ("a_log", "dt_bias", "w_in"))
BF16_GRAD_RATIO = 2.0
# The same step at full width cut to SHALLOW_LAYERS layers (one
# shared-attention application), 2 x 1024, where bf16's rounding has not
# yet grown past a lost gradient's size: per leaf, the kernel path's and
# the bf16 plain path's largest distance from the fp32 oracle within
# SHALLOW_OWN_TOL of the leaf's own max |g|, and their L2 distance within
# SHALLOW_L2_TOL of its norm (a lost gradient is 1.0 off).  Stated in
# PERF.md before the first run, at 4 layers, with the rule to take fewer
# layers where the bf16 plain path fails them: it did at 4 (0.44 of own
# max, 0.15 L2) and at 2 (0.115, 0.055), and passed at 1 (PERF.md)
SHALLOW_LAYERS = 1
SHALLOW_OWN_TOL = 0.05
SHALLOW_L2_TOL = 0.05
# The kernels' input leaves (a_log, dt_bias, w_in, wq, wk, wv) also by the
# ratio in L2 (the distance's norm over the oracle's), and not zero.  No
# distance from the fp32 oracle tells a lost gradient from bf16's
# rounding at this depth from random init: the bf16 plain path itself is
# 0.38-1.05 of the oracle's norm from it on these leaves, so the own-max
# (0.5) and L2 (0.5) gates first stated failed it as much as the kernels
# (PERF.md section 6); the per-kernel bf16 phases, on identical inputs, hold
# each gradient to 1e-3 of its own max
# one step's gradients of Model.loss at the 100m training shape, the
# flash kernels against the plain attention, both fp32 on the card:
# every leaf within FLASH_BWD_TOL of max(1, max |g|); wq, wk and wv
# also within 1e-3 of their own max |g| (their gradients are far below
# 1, where the first gate is all but absolute; a wrong or missing dq,
# dk or dv is off by the order of the gradient itself).  Stated before
# the check's first run on the card
GRAD_ATTN_REL_TOL = 1e-3
# the robust runs: (label, policy, FLConfig overrides, launches per round
# of each kernel).  The attack and the trim follow the reference's robust
# benchmark (benchmarks/bench_robust.py); the geometric median runs 6
# Weiszfeld steps, each one norm and one weighted sum, after the mean
ATTACK = dict(adversary="sign_flip",
              adversary_params=(("malicious_frac", 0.2),))
SERVE_ONLY = {"flash_attention": 0, "flash_attention_lse": 0, "ssm_scan": 0,
              "rwkv6_scan": 0, "flash_attention_bwd": 0, "ssm_scan_bwd": 0,
              "rwkv6_scan_bwd": 0}
ROBUST_RUNS = [
    ("geometric_median", "flude", dict(agg_rule="geometric_median"),
     {"fed_agg": 7, "residual_norms": 6, **SERVE_ONLY}),
    ("trust", "flude", dict(agg_rule="trust"),
     {"fed_agg": 1, "residual_norms": 1, **SERVE_ONLY}),
    ("trimmed_mean", "random",
     dict(agg_rule="trimmed_mean", agg_rule_params=(("trim", 0.3),)),
     {"fed_agg": 0, "residual_norms": 0, **SERVE_ONLY}),
]


def log(*args):
    print(*args, flush=True)


_SLEEP_RATE = []


def sleep_cycles_per_ms():
    """Cycles of ``torch.cuda._sleep`` a millisecond on this card, read
    once."""
    if not _SLEEP_RATE:
        cycles = 10_000_000
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_RATE.append(cycles / start.elapsed_time(end))
    return _SLEEP_RATE[0]


def cuda_ms(fn, reps=100, warmup=10):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls.  The
    calls are queued behind a ``torch.cuda._sleep`` that covers the
    host's time to issue them (1.5 times the later warm-up calls' host
    time, at most 200 ms), so the card runs them back to back even where
    issuing a call takes longer than its kernels run (a ~20 us kernel)."""
    torch.cuda.synchronize()
    for i in range(warmup):
        if i == warmup // 2:
            t0 = time.perf_counter()
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / (warmup - warmup // 2) \
        if warmup else 1.0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * host_ms * reps + 0.1, 200.0)
                          * sleep_cycles_per_ms()))
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
    import re
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    builds = _build.build_all()
    log(f"[build] {len(builds)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, b in builds.items():
        log(f"[build] {name}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        for line in ptxas_lines(b.report):
            log(f"[build]   {line}")
        for line in _build.ptxas_warnings(b.report):
            log(f"[build]   {line}")
    check_flash_build(builds["flash_attention"].report)
    check_flash_bwd_build(builds["flash_attention_bwd"].report)
    check_ssd_bwd_build(builds["ssm_scan_bwd_mma"].report)
    check_ssd_fwd_build(builds["ssm_scan"].report)
    for name in ("ssm_scan", "rwkv6_scan", "flash_attention_bwd",
                 "ssm_scan_bwd", "rwkv6_scan_bwd"):
        for kernel, k in sorted(_build.ptxas_kernels(
                builds[name].report).items()):
            short = re.search(r"(ssd|wkv)_(fwd|bwd)_\w+?E(?=vN)|flash_bwd_"
                              r"\w+?(ILi\d+E|E)(?=N|v)", kernel)
            log(f"[build] {short.group(0) if short else kernel}: "
                f"{k.registers} registers at launch, spills "
                f"{k.spill_stores} / {k.spill_loads} bytes")


def check_flash_build(report):
    """Each flash_attention variant's registers, shared memory and
    spills; raises on a ptxas line saying wgmma instructions were
    serialised, on any spill of the bf16 wgmma variant at the serve head
    dims (64, 80, 128) and on any spill of the fp32 tensor-core variant
    (``flash_fwd_f32``) at D 32 to 128 (at D 192, not a training shape,
    logged)."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import smem_bytes
    serialised = _build.wgmma_serialised(report)
    gated = {"wgmma": (64, 80, 128), "f32": (32, 64, 80, 128)}
    seen = 0
    for name, k in sorted(_build.ptxas_kernels(report).items()):
        m = re.search(r"flash_fwd_(wgmma|f32|simt)ILi(\d+)E", name)
        if not m:
            continue
        kind, D = m.group(1), int(m.group(2))
        seen += kind == "f32"
        variant = "wgmma_f32" if kind == "f32" else kind
        log(f"[build] flash_fwd_{kind}<{D}>: {k.registers} registers at "
            f"launch, {smem_bytes(variant, D)} bytes of dynamic shared "
            f"memory, spills {k.spill_stores} / {k.spill_loads} bytes")
        if D in gated.get(kind, ()) and (k.spill_stores or k.spill_loads):
            raise RuntimeError(f"flash_fwd_{kind}<{D}> spills registers")
    if seen != 5:
        raise RuntimeError(f"flash_fwd_f32: {seen} instantiations in the "
                           f"ptxas report, expected 5 (one a head dim)")
    if serialised:
        raise RuntimeError("ptxas serialised wgmma instructions: "
                           + "; ".join(serialised))


def check_flash_bwd_build(report):
    """Each tensor-core backward kernel's registers, shared memory and
    spills (bf16 ``flash_bwd_wgmma_*``, fp32 ``flash_bwd_f32_*``); raises
    on a ptxas line saying wgmma instructions were serialised and on any
    spill at the training head dims (bf16 64, 80, 128; fp32 32 to 128:
    at D 192 the fp32 dq kernel's 96-register sum and its tile's partial
    spill, logged)."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import bwd_smem_bytes
    gated = {"wgmma": (64, 80, 128), "f32": (32, 64, 80, 128)}
    for name, k in sorted(_build.ptxas_kernels(report).items()):
        m = re.search(r"flash_bwd_(wgmma|f32)_(dq|dkdv)ILi(\d+)E", name)
        if not m:
            continue
        kind, kernel, D = m.group(1), m.group(2), int(m.group(3))
        log(f"[build] flash_bwd_{kind}_{kernel}<{D}>: {k.registers} "
            f"registers at launch, "
            f"{bwd_smem_bytes(D, kind + '_' + kernel)} bytes of dynamic "
            f"shared memory, spills {k.spill_stores} / {k.spill_loads} "
            f"bytes")
        if D in gated[kind] and (k.spill_stores or k.spill_loads):
            raise RuntimeError(f"flash_bwd_{kind}_{kernel}<{D}> spills "
                               f"registers")
    serialised = _build.wgmma_serialised(report)
    if serialised:
        raise RuntimeError("ptxas serialised wgmma instructions of the "
                           "backward: " + "; ".join(serialised))


def check_ssd_bwd_build(report):
    """Each ssd_bwd_mma instantiation's registers, shared memory and
    spills (by x dtype, dt dtype, P and N: ``ssd_bwd_mma`` on bf16 x, B
    and C, ``ssd_bwd_mma_f32`` on fp32 ones); raises on any spill at P =
    N = 64, zamba2-1.2b's heads, and unless each kernel has its 8
    instantiations."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan.kernel import bwd_smem_bytes
    seen = {"bf16": 0, "fp32": 0}
    for name, k in sorted(_build.ptxas_kernels(report).items()):
        m = re.search(r"ssd_bwd_mma(_f32)?I(f|13__nv_bfloat16)Li(\d+)ELi"
                      r"(\d+)E", name)
        if not m:
            continue
        x = "fp32" if m.group(1) else "bf16"
        seen[x] += 1
        dt, P, N = ("fp32" if m.group(2) == "f" else "bf16",
                    int(m.group(3)), int(m.group(4)))
        kernel = f"ssd_bwd_mma{m.group(1) or ''}<{dt} dt, P {P}, N {N}>"
        variant = "mma_f32" if m.group(1) else "mma_bf16"
        log(f"[build] {kernel}: {k.registers} registers at launch, "
            f"{bwd_smem_bytes(P, N, variant)} bytes of dynamic shared "
            f"memory, spills {k.spill_stores} / {k.spill_loads} bytes")
        if P == 64 and N == 64 and (k.spill_stores or k.spill_loads):
            raise RuntimeError(f"{kernel} spills registers")
    if seen != {"bf16": 8, "fp32": 8}:
        raise RuntimeError(f"ssd_bwd_mma: {seen} instantiations by x dtype "
                           f"in the ptxas report, expected 8 each (2 dt "
                           f"dtypes x 4 (P, N))")


def check_ssd_fwd_build(report):
    """Each ssd_fwd_mma_f32 instantiation's registers, shared memory and
    spills (by dt dtype, P / 2 and N); raises on a spill of more than
    SSD_FWD_SPILL_MAX bytes at P = N = 64, zamba2-1.2b's heads, and
    unless it has its 8 instantiations."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan.kernel import smem_bytes
    seen = 0
    for name, k in sorted(_build.ptxas_kernels(report).items()):
        m = re.search(r"ssd_fwd_mma_f32I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
                      name)
        if not m:
            continue
        seen += 1
        dt, PB, N = ("fp32" if m.group(1) == "f" else "bf16",
                     int(m.group(2)), int(m.group(3)))
        kernel = f"ssd_fwd_mma_f32<{dt} dt, P {2 * PB}, N {N}>"
        log(f"[build] {kernel}: {k.registers} registers at launch, "
            f"{smem_bytes('mma_f32', 2 * PB, N)} bytes of dynamic shared "
            f"memory, spills {k.spill_stores} / {k.spill_loads} bytes")
        if PB == 32 and N == 64 and max(k.spill_stores, k.spill_loads) \
                > SSD_FWD_SPILL_MAX:
            raise RuntimeError(f"{kernel} spills more than "
                               f"{SSD_FWD_SPILL_MAX} bytes of registers")
    if seen != 8:
        raise RuntimeError(f"ssd_fwd_mma_f32: {seen} instantiations in the "
                           f"ptxas report, expected 8 (2 dt dtypes x 4 "
                           f"(P, N))")


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
    from repro_torch.kernels.fed_agg.kernel import fed_agg_cuda, geometry
    from repro_torch.kernels.fed_agg.ref import fed_agg_ref
    C, D = MAIN_N, MAIN_D
    # (label, C, D, zero weights, elements the buffer starts past a
    # 16-byte boundary)
    cases = [("main", C, D, False, 0), ("ragged C", 13, D, False, 0),
             ("ragged D", C, 1, False, 0), ("zero weights", C, D, True, 0),
             ("D = 0 mod 4", C, D - 2, False, 0),
             ("D = 1 mod 4, C off the chunks", C - 3, D - 1, False, 0),
             ("D = 3 mod 4 (odd)", C, D + 1, False, 0),
             ("rows start 4 bytes off", 999, D, False, 1),
             ("odd D, rows start 12 bytes off", 999, D + 1, False, 3),
             ("cohort X = 512", COHORT_X, D, False, 0),
             ("cohort X = 512, 1M-fleet model", COHORT_X, D_1M, False, 0)]
    max_err = 0.0
    for label, c, d, zero, off in cases:
        u, w = _agg_inputs(c, d, seed=c + d, zero_weights=zero)
        if off:
            flat = torch.empty(c * d + off, device="cuda")
            flat[off:] = u.reshape(-1)
            u = flat[off:].view(c, d)
        g = geometry(c, d, aligned=u.data_ptr() % 8 == 0)
        got = fed_agg_cuda(u, w)
        again = fed_agg_cuda(u, w)
        torch.cuda.synchronize()
        want = fed_agg_ref(u, w)
        scale = fed_agg_ref(u.abs(), w.abs())
        err = (got - want).abs()
        rel = float((err / scale.clamp_min(1e-30)).max())
        max_err = max(max_err, float(err.max()))
        log(f"[fed_agg] {label} ({c}, {d}; {g.col_blocks} x {g.n_chunks} "
            f"blocks, {'float2' if g.vec == 2 else 'scalar'} loads): max abs"
            f" err {float(err.max()):.3e}, max err / sum|w*u| {rel:.3e}, "
            f"reruns bit-identical {bool(torch.equal(got, again))}")
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"fed_agg {label}: non-finite output")
        if not bool((err <= REL_TOL * scale + 1e-30).all()):
            raise RuntimeError(f"fed_agg {label}: error {rel:.3e} of "
                               f"sum|w*u| exceeds {REL_TOL}")
        if not torch.equal(got, again):
            raise RuntimeError(f"fed_agg {label}: two launches differ")
        if zero and bool((got != 0).any()):
            raise RuntimeError("fed_agg: all-zero weights gave non-zeros")
        del u, w, got, again, want, scale, err

    main = time_fed_agg(C, D)
    cohort = [time_fed_agg(COHORT_X, d) for d in (D, D_1M)]
    return {"name": "fed_agg", "route": "cuda",
            "source": "src/repro_torch/csrc/fed_agg.cu",
            "replaces": "src/repro/kernels/fed_agg/kernel.py:37",
            "launches": None, "max_abs_err": max_err, **main,
            "at_cohort_shapes": cohort}


def rotating(fn, args):
    """A call of ``fn`` on the next of the argument tuples ``args`` each
    time: timed calls that cycle through copies larger together than the
    L2 read every input from device memory, as the bound counts."""
    it = [0]

    def call():
        a = args[it[0] % len(args)]
        it[0] += 1
        return fn(*a)
    return call


def l2_copies(*tensors):
    """Copies of ``tensors`` (the first as is) that together hold three
    times the H100's L2: a (512, D) buffer of 36-45 MB fits in its 50
    MB, and back-to-back calls on one copy would read it from there."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, -(-3 * H100_L2_BYTES // nbytes))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def time_fed_agg(C, D):
    """fed_agg's time at (C, D) beside its plain version, one torch.mv
    and the bound; the times and the bound in ms."""
    from repro_torch.kernels.fed_agg.kernel import fed_agg_cuda
    from repro_torch.kernels.fed_agg.ref import fed_agg_ref
    copies = l2_copies(*_agg_inputs(C, D, seed=1))
    mv = rotating(lambda u, w: torch.mv(u.t(), w), copies)
    kernel = rotating(fed_agg_cuda, copies)
    # in turns: library, kernel, kernel, library
    lib = [cuda_ms(mv)]
    kern = [cuda_ms(kernel) for _ in range(2)]
    lib.append(cuda_ms(mv))
    ms, library_ms = sum(kern) / 2, sum(lib) / 2
    plain_ms = cuda_ms(rotating(fed_agg_ref, copies))
    nbytes = (C * D + C + D) * 4
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = 2 * C * D / H100_FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[fed_agg] ({C}, {D}) fp32: kernel {ms * 1e3:.1f} us "
        f"({kern[0] * 1e3:.1f} / {kern[1] * 1e3:.1f}), plain "
        f"{plain_ms * 1e3:.1f} us, torch.mv {library_ms * 1e3:.1f} us "
        f"({lib[0] * 1e3:.1f} / {lib[1] * 1e3:.1f}); bound "
        f"{bound_ms * 1e3:.1f} us ({nbytes} bytes at 3.35 TB/s): kernel at "
        f"{bound_ms / ms:.1%} of bound, torch.mv at "
        f"{bound_ms / library_ms:.1%}; kernel / torch.mv "
        f"{ms / library_ms:.3f}; {nbytes / (ms * 1e-3) / 1e12:.2f} TB/s")
    return {"at": [C, D], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
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
             ("u == z", C, D), ("cohort X = 512", COHORT_X, D),
             ("cohort X = 512, u == z", COHORT_X, D)]
    max_err = 0.0
    for label, c, d in cases:
        gen = torch.Generator(device="cuda").manual_seed(c + d)
        z = torch.randn((d,), generator=gen, device="cuda")
        u = z.expand(c, d).contiguous() if "u == z" in label else \
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

    main = time_residual_norms(C, D)
    cohort = time_residual_norms(COHORT_X, D)
    return {"name": "residual_norms", "route": "cuda",
            "source": "src/repro_torch/csrc/robust_agg.cu",
            "replaces": "src/repro/kernels/robust_agg/kernel.py:42",
            "launches": None, "max_abs_err": max_err, **main,
            "at_cohort_shapes": [cohort]}


def time_residual_norms(C, D):
    """residual_norms' time at (C, D) beside its plain version, one
    torch.cdist and the bound; the times and the bound in ms."""
    from repro_torch.kernels.robust_agg.kernel import residual_norms_cuda
    from repro_torch.kernels.robust_agg.ref import residual_norms_ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    u = torch.randn((C, D), generator=gen, device="cuda")
    z = torch.randn((D,), generator=gen, device="cuda")
    copies = l2_copies(u, z)
    ms = cuda_ms(rotating(residual_norms_cuda, copies))
    plain_ms = cuda_ms(rotating(residual_norms_ref, copies))
    library_ms = cuda_ms(rotating(lambda u, z: torch.cdist(
        u, z[None], compute_mode="donot_use_mm_for_euclid_dist"), copies))
    nbytes = (C * D + D + C) * 4
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = 3 * C * D / H100_FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[residual_norms] ({C}, {D}) fp32: kernel {ms * 1e3:.1f} us, "
        f"plain {plain_ms * 1e3:.1f} us, torch.cdist {library_ms * 1e3:.1f}"
        f" us; bound {bound_ms * 1e3:.1f} us ({nbytes} bytes at 3.35 TB/s),"
        f" {bound_ms / ms:.1%} of bound, "
        f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s")
    return {"at": [C, D], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def visible_pairs(Sq, Sk, q_offset, causal, window):
    """(query, key) pairs the masks leave visible, per (batch, head): the
    work this run's inputs need (rows with no visible key are not
    counted)."""
    qp = q_offset + torch.arange(Sq, dtype=torch.int64)
    lo = (qp - window + 1).clamp_min(0) if window else torch.zeros_like(qp)
    hi = qp.clamp(max=Sk - 1) if causal else torch.full_like(qp, Sk - 1)
    return int((hi - lo + 1).clamp_min(0).sum())


def flash_bounds(B, Hq, Hkv, Sq, Sk, D, dtype, q_offset, causal, window):
    """(bytes, flops, bytes ms, bf16 tensor-core ms, fp32 ms): q, k, v
    read once and o written once; QKᵀ and P·V over the visible pairs, 2
    flops a multiply-add."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D) * esize
    flops = 4 * B * Hq * D * visible_pairs(Sq, Sk, q_offset, causal, window)
    return (nbytes, flops, nbytes / H100_BYTES_PER_S * 1e3,
            flops / H100_BF16_FLOPS * 1e3, flops / H100_FP32_FLOPS * 1e3)


def _flash_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Hq, Sq, D), generator=gen, device="cuda")
    k = torch.randn((B, Hkv, Sk, D), generator=gen, device="cuda")
    v = torch.randn((B, Hkv, Sk, D), generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def check_flash(label, got, q, k, v, **kw):
    """Raise unless ``got`` (a kernel output) is finite, of q's dtype and
    shape, and within the fp32 tolerance or the bf16 gate; returns its
    max abs error against the plain version and a note for the log."""
    from repro_torch.kernels.flash_attention.ref import (
        BF16_FLOOR, attention_ref, bf16_excess)
    if got.dtype != q.dtype or got.shape != q.shape \
            or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"flash_attention {label}: output {got.dtype} "
                           f"{tuple(got.shape)} or non-finite")
    if got.dtype == torch.float32:
        want = attention_ref(q, k, v, **kw)
        err = (got - want).abs()
        tol = FLASH_F32_TOL * torch.maximum(got.abs(),
                                            want.abs()).clamp_min(1.0)
        worst = float(err.max())
        if not bool((err <= tol).all()):
            raise RuntimeError(f"flash_attention {label}: error "
                               f"{worst:.3e} above {FLASH_F32_TOL} of "
                               f"max(1, |o|)")
        return worst, f"max abs err {worst:.3e}"
    truth = attention_ref(q.float(), k.float(), v.float(), **kw)
    err = float((got.float() - truth).abs().max())
    excess = bf16_excess(got, truth)
    del truth
    note = (f"max abs err against the fp32 truth {err:.3e}, excess beyond "
            f"one bf16 ulp {excess:.3e} of the row's max |o| (gate "
            f"{BF16_FLOOR:.3e})")
    if not excess <= BF16_FLOOR:
        raise RuntimeError(f"flash_attention {label}: {note}")
    return err, note


def phase_flash_attention():
    """flash_attention against attention_ref on the card at the serve
    shapes and at ragged ones, which variant ran, bit-identical reruns;
    timings at the three serve shapes beside SDPA and the bound; returns
    its kernels-line entry (``launches`` is filled in by the serve
    runs)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    flash_attention_cuda = FK.flash_attention_cuda
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, Hq, Hkv, Sq, Sk, D, dtype, q_offset, causal, window)
    cases = [
        ("qwen2-7b prefill", *FLASH_QWEN2),
        ("h2o-danube-1.8b prefill", *FLASH_DANUBE),
        ("zamba2-1.2b prefill", *FLASH_ZAMBA2),
        ("ragged Sq, Sk, D 64, group 1", 1, 3, 3, 100, 100, 64, f32, 0,
         True, None),
        ("q_offset 37, Sq < Sk, group 7", 2, 14, 2, 70, 107, 64, f32, 37,
         True, None),
        ("q_offset, window 50, group 7", 1, 7, 1, 130, 190, 64, f32, 60,
         True, 50),
        ("non-causal, window, some rows fully masked", 1, 4, 2, 65, 64, 80,
         f32, 50, False, 20),
        ("ragged bf16 D 80", 1, 4, 2, 77, 77, 80, bf16, 0, True, None),
        # the other dense configs' head dims: flude-paper's (the serve
        # entry point's default --arch) and nemotron-4-340b's
        ("ragged D 32, group 2", 2, 8, 4, 100, 100, 32, f32, 0, True,
         None),
        ("ragged bf16 D 192, window 64, group 12", 1, 96, 8, 150, 150, 192,
         bf16, 0, True, 64),
        # bf16 at every head dim: ragged Sq and Sk, windows, q_offset,
        # one query, rows that see no key
        ("bf16 D 32, ragged, window 40, group 2", 2, 8, 4, 100, 100, 32,
         bf16, 0, True, 40),
        ("bf16 D 64, q_offset 230, Sq < Sk, group 7", 2, 14, 2, 70, 300, 64,
         bf16, 230, True, None),
        ("bf16 D 64, non-causal window, rows 29.. see no key", 1, 4, 2,
         160, 200, 64, bf16, 200, False, 30),
        ("bf16 D 80, ragged, window 300", 1, 8, 2, 777, 777, 80, bf16, 0,
         True, 300),
        ("bf16 D 128, one query, q_offset 76", 1, 4, 4, 1, 77, 128, bf16,
         76, True, None),
        ("bf16 D 128, q_offset 667, window 100, group 7", 1, 7, 1, 333,
         1000, 128, bf16, 667, True, 100),
        ("bf16 D 128, non-causal, ragged Sq", 1, 4, 2, 130, 256, 128, bf16,
         0, False, None),
        # fp32 at the other head dims and at the 100m S 2048 training shape
        ("fp32 D 128, one query, q_offset 76", 1, 4, 4, 1, 77, 128, f32, 76,
         True, None),
        ("fp32 D 128, causal, group 4", 2, 8, 2, 300, 300, 128, f32, 0, True,
         None),
        ("fp32 D 192, ragged, window 64, group 3", 1, 6, 2, 150, 150, 192,
         f32, 0, True, 64),
        ("fp32 D 80, ragged, window 300", 1, 8, 2, 777, 777, 80, f32, 0,
         True, 300),
        ("fp32 100m S 2048 training", 8, 12, 4, 2048, 2048, 64, f32, 0, True,
         None),
    ]
    max_err, max_err_f32 = 0.0, 0.0
    for label, B, Hq, Hkv, Sq, Sk, D, dt, off, causal, window in cases:
        q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Sk, D, dt, seed=Sq + Sk + D)
        kw = dict(causal=causal, window=window, q_offset=off)
        before = dict(FK.launches_by_variant)
        got = flash_attention_cuda(q, k, v, **kw)
        ran = [n for n, c in FK.launches_by_variant.items()
               if c > before[n]]
        again = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        if ran != [FK.VARIANTS[dt]]:
            raise RuntimeError(f"flash_attention {label}: {str(dt)[6:]} "
                               f"ran variant(s) {ran}")
        err, note = check_flash(label, got, q, k, v, **kw)
        same = bool(torch.equal(got, again))
        max_err = max(max_err, err)
        if dt == f32:
            max_err_f32 = max(max_err_f32, err)
            # the SIMT variant by name, the yardstick, at the same gate
            simt = flash_attention_cuda(q, k, v, variant="simt", **kw)
            torch.cuda.synchronize()
            _, simt_note = check_flash(f"{label}, simt", simt, q, k, v, **kw)
            note += f"; simt {simt_note}"
            del simt
        log(f"[flash_attention] {label} (B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Sk{Sk} "
            f"D{D} {str(dt)[6:]} q_offset {off} causal {causal} window "
            f"{window}), {ran[0]}: {note}; reruns bit-identical {same}")
        if not same:
            raise RuntimeError(f"flash_attention {label}: two launches "
                               f"differ")
        del q, k, v, got, again

    phase_flash_model_layout()

    timings = {}
    for label, shape in (("qwen2-7b", FLASH_QWEN2),
                         ("h2o-danube-1.8b", FLASH_DANUBE),
                         ("zamba2-1.2b", FLASH_ZAMBA2)):
        B, Hq, Hkv, Sq, Sk, D, dt, off, causal, window = shape
        q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Sk, D, dt, seed=1)
        kw = dict(causal=causal, window=window, q_offset=off)
        if window is None:
            what = "sdpa(is_causal, enable_gqa)"

            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
        else:
            what = "sdpa(boolean window mask, enable_gqa)"
            qp = torch.arange(Sq, device="cuda")[:, None] + off
            kp = torch.arange(Sk, device="cuda")[None, :]
            mask = (kp <= qp) & (kp > qp - window)

            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
        # in turns: library, kernel, kernel, library
        lib = [cuda_ms(library, reps=10, warmup=2)]
        kern = [cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw),
                        reps=10, warmup=2) for _ in range(2)]
        lib.append(cuda_ms(library, reps=10, warmup=2))
        ms, library_ms = sum(kern) / 2, sum(lib) / 2
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **kw), reps=3,
                           warmup=1)
        nbytes, flops, bytes_ms, bf16_ms, fp32_ms = flash_bounds(*shape)
        bound_ms = max(bytes_ms, bf16_ms)
        log(f"[flash_attention] {label} timing ({FK.VARIANTS[dt]}): kernel "
            f"{ms:.3f} ms ({kern[0]:.3f} / {kern[1]:.3f}), plain "
            f"{plain_ms:.3f} ms, {what} {library_ms:.3f} ms ({lib[0]:.3f} / "
            f"{lib[1]:.3f}); bound {bound_ms * 1e3:.1f} us on bf16 tensor "
            f"cores ({flops:.4e} flops at 989.4 TFLOP/s; {nbytes} bytes "
            f"take {bytes_ms * 1e3:.1f} us at 3.35 TB/s); kernel at "
            f"{bound_ms / ms:.1%} of the bound ({flops / ms / 1e9:.1f} "
            f"TFLOP/s), sdpa at {bound_ms / library_ms:.1%}; kernel / sdpa "
            f"{ms / library_ms:.3f}")
        timings[label] = dict(ms=ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound_ms,
                              bound_by="bytes" if bytes_ms >= bf16_ms
                              else "operations")
        del q, k, v
    head = timings["qwen2-7b"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:69",
            "launches": None, "max_abs_err": max_err, **head,
            "at": "qwen2-7b prefill shape", "by_shape": timings,
            "fp32_max_abs_err": max_err_f32}


def phase_flash_model_layout():
    """The serve path's own call: ``flash_attention_model_layout`` at the
    Qwen2-7B prefill shape, q (B, S, Hkv, G, D) and k, v (B, S, Hkv, D)
    as the projections lay them out, which the kernel reads as strided
    (B, H, S, D) views through its tensor maps; held to the bf16 gate on
    those views."""
    from repro_torch.kernels.flash_attention.ops import \
        flash_attention_model_layout
    B, Hq, Hkv, S, _, D, dt, _, _, _ = FLASH_QWEN2
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((B, S, Hkv, Hq // Hkv, D), generator=gen,
                    device="cuda").to(dt)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dt)
    got = flash_attention_model_layout(q, k, v, causal=True, impl="cuda")
    torch.cuda.synchronize()
    err, note = check_flash(
        "model layout", got.reshape(B, S, Hq, D).transpose(1, 2),
        q.reshape(B, S, Hq, D).transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), causal=True)
    log(f"[flash_attention] qwen2-7b prefill in the model layout (q "
        f"{tuple(q.shape)}, k/v {tuple(k.shape)} read as strided (B, H, S, "
        f"D) views): {note}")
    del q, k, v, got


def ssd_bounds(B, S, H, P, N, G, dtype, with_h0):
    """(bytes, flops, bytes ms, bf16 tensor-core ms, fp32 ms) of one
    ssm_scan call: x, dt, A, B, C (and h0 when given) read once, y and the
    final state written once; the chunked form's products at the kernel's
    chunk of 64 (the last chunk ragged): per chunk of L rows C·Bᵀ and
    M·(x·dt) over the L(L+1)/2 pairs l <= i, C·stateᵀ and the state
    update, 2 flops a multiply-add."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = ((B * S * H * P + 2 * B * S * G * N) * esize
              + (B * S * H + H) * 4 + B * S * H * P * 4
              + B * H * P * N * 4 * (2 if with_h0 else 1))
    flops = 0
    for c0 in range(0, S, 64):
        L = min(64, S - c0)
        tri = L * (L + 1) // 2
        flops += 2 * tri * N + 2 * tri * P + 4 * L * N * P
    flops *= B * H
    return (nbytes, flops, nbytes / H100_BYTES_PER_S * 1e3,
            flops / H100_BF16_FLOPS * 1e3, flops / H100_FP32_FLOPS * 1e3)


def _ssd_inputs(B, S, H, P, N, G, dtype, seed, with_h0=False):
    """The model's layout: x, B and C are views of one (B, S, H·P +
    2·G·N) tensor, as ``ssm_forward`` splits its conv output; dt a
    softplus, A = -exp(a_log)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xbc = (torch.randn((B, S, H * P + 2 * G * N), generator=gen,
                       device="cuda") * 0.5).to(dtype)
    x, Bm, Cm = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda"))
    A = -torch.exp(torch.rand((H,), generator=gen, device="cuda") * 2.8)
    h0 = torch.randn((B, H, P, N), generator=gen, device="cuda") \
        if with_h0 else None
    return (x.reshape(B, S, H, P), dt, A, Bm.reshape(B, S, G, N),
            Cm.reshape(B, S, G, N), h0)


def _check_scan(tag, label, got, want, rel):
    """Max abs error, and raise unless every element is within ``rel``
    of max(1, |want|) and finite."""
    err = (got - want).abs()
    worst = float((err / want.abs().clamp_min(1.0)).max())
    if not bool(torch.isfinite(got).all()) or worst > rel:
        raise RuntimeError(f"{tag} {label}: error {worst:.3e} of max(1, "
                           f"|plain|) above {rel} or non-finite output")
    return float(err.max()), worst


def phase_ssm_scan():
    """ssm_scan against ssm_scan_ref on the card at the zamba2-1.2b
    prefill shape and at ragged ones (S off the chunk, G 2 with H 4, P 32
    / N 16, a nonzero h0 carried across two calls, S 1), each case through
    the op's default variant (bf16: ssd_fwd_mma, fp32: ssd_fwd_mma_f32)
    and each fp32 case once more through ssd_fwd_simt by name, both held
    to the plain version at SSM_REL, every call's variant read off the
    launch counter, reruns of the default bit-identical; the bf16 variant
    timed at the prefill shape beside the bound (the fp32 ones at the
    training shapes and the layer: ``phase_scan_fwd_fp32``); returns its
    kernels-line entry (``launches`` is filled in by the serve runs)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    for line in ptxas_lines(_build.build_all(["ssm_scan"])
                            ["ssm_scan"].report):
        log(f"[ssm_scan] ptxas: {line}")
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, P, N, G, dtype, h0, split the call at)
    cases = [
        ("zamba2-1.2b prefill", *SSM_ZAMBA2, False, None),
        ("zamba2-1.2b prefill, fp32", *SSM_ZAMBA2[:-1], f32, False, None),
        ("ragged S 1000, G 2, H 4, P 32 / N 16", 2, 1000, 4, 32, 16, 2,
         f32, False, None),
        ("ragged S 1000, G 2, H 4, P 32 / N 16, bf16", 2, 1000, 4, 32, 16,
         2, bf16, False, None),
        ("h0 carried across two calls (S 130 + 170)", 2, 300, 4, 64, 64, 2,
         bf16, True, 130),
        ("ragged S 77, P 64 / N 16, G 4, h0", 1, 77, 8, 64, 16, 4, f32,
         True, None),
        ("S 1, P 32 / N 64", 3, 1, 2, 32, 64, 1, f32, True, None),
        ("S 1, P 32 / N 64, bf16", 3, 1, 2, 32, 64, 1, bf16, True, None),
        ("h0 carried across two calls (S 130 + 170), fp32", 2, 300, 4, 64,
         64, 2, f32, True, 130),
        ("training 100m (B 32, S 128, H 24), fp32", 32, 128, 24, 64, 64, 1,
         f32, False, None),
    ]
    max_err = fp32_max_err = simt_max_err = 0.0
    for label, B, S, H, P, N, G, dt_, with_h0, split in cases:
        x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, S, H, P, N, G, dt_,
                                           seed=S + H, with_h0=with_h0)
        before = dict(SK.launches.by_variant)
        if split is None:
            got = ssm_scan(x, dt, A, Bm, Cm, h0)
        else:
            y1, h1 = ssm_scan(x[:, :split], dt[:, :split], A,
                              Bm[:, :split], Cm[:, :split], h0)
            y2, h2 = ssm_scan(x[:, split:], dt[:, split:], A,
                              Bm[:, split:], Cm[:, split:], h1)
            got = (torch.cat([y1, y2], 1), h2)
        again = ssm_scan(x, dt, A, Bm, Cm, h0)
        third = ssm_scan(x, dt, A, Bm, Cm, h0)
        simt = None
        if dt_ == f32:
            k = [t.transpose(1, 2) for t in (x, dt, Bm, Cm)]
            ys, hs = SK.ssm_scan_cuda(k[0], k[1], A, k[2], k[3], h0,
                                      variant="simt")
            simt = (ys.transpose(1, 2), hs)
        torch.cuda.synchronize()
        ran = {v: n - before[v] for v, n in SK.launches.by_variant.items()}
        default = SK.VARIANTS[dt_]
        calls = 3 if split is None else 4
        expect = {v: calls if v == default else
                  int(v == "simt" and simt is not None) for v in ran}
        if ran != expect:
            raise RuntimeError(f"ssm_scan {label}: launches {ran}, "
                               f"expected {expect}")
        want = ssm_scan(x, dt, A, Bm, Cm, h0, impl="torch")
        ey, ry = _check_scan("ssm_scan", label, got[0], want[0], SSM_REL)
        eh, rh = _check_scan("ssm_scan", label + " state", got[1],
                             want[1], SSM_REL)
        same = bool(torch.equal(again[0], third[0])
                    and torch.equal(again[1], third[1]))
        max_err = max(max_err, ey, eh)
        note = ""
        if simt is not None:
            fp32_max_err = max(fp32_max_err, ey, eh)
            sy, _ = _check_scan("ssm_scan simt", label, simt[0], want[0],
                                SSM_REL)
            sh, _ = _check_scan("ssm_scan simt", label + " state", simt[1],
                                want[1], SSM_REL)
            simt_max_err = max(simt_max_err, sy, sh)
            note = f"; simt by name: y {sy:.3e}, state {sh:.3e}"
        log(f"[ssm_scan] {label} (B{B} S{S} H{H} P{P} N{N} G{G} "
            f"{str(dt_)[6:]}, {default}, h0 {with_h0}): y max abs "
            f"err {ey:.3e} "
            f"({ry:.3e} of max(1, |y|)), state {eh:.3e} ({rh:.3e}){note}; "
            f"reruns bit-identical {same}; launches {ran}")
        if not same:
            raise RuntimeError(f"ssm_scan {label}: two launches differ")
        del x, dt, A, Bm, Cm, h0, got, again, third, want, simt

    x, dt, A, Bm, Cm, _ = _ssd_inputs(*SSM_ZAMBA2, seed=1)
    ms = min(cuda_ms(lambda: ssm_scan(x, dt, A, Bm, Cm), reps=20,
                     warmup=3) for _ in range(2))
    plain_ms = cuda_ms(lambda: ssm_scan(x, dt, A, Bm, Cm, impl="torch"),
                       reps=2, warmup=1)
    nbytes, flops, bytes_ms, bf16_ms, fp32_ms = ssd_bounds(*SSM_ZAMBA2,
                                                           False)
    bound_ms = max(bytes_ms, bf16_ms)
    log(f"[ssm_scan] zamba2-1.2b timing: ssd_fwd_mma (bf16) {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms (the per-step oracle), no library call; "
        f"bound {bound_ms * 1e3:.1f} us ({nbytes} bytes at 3.35 TB/s; "
        f"{flops:.4e} flops take {bf16_ms * 1e3:.1f} us on bf16 tensor "
        f"cores); kernel at {bound_ms / ms:.1%} of the bound")
    del x, dt, A, Bm, Cm
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:66",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= bf16_ms else "operations",
            "library_ms": None, "at": "zamba2-1.2b prefill shape",
            "variant": "mma", "fp32_max_abs_err": fp32_max_err,
            "simt_max_abs_err": simt_max_err}


def wkv_bounds(B, S, H, D, dtype, with_s0):
    """(bytes, flops, bytes ms, bf16 tensor-core ms, fp32 ms) of one
    rwkv6_scan call: r, k, v, logw (fp32), u (and s0 when given) read
    once, y and the final state written once.  The flops are those of the
    chunked form's products (``wkv_chunked``) at a chunk of 64 (the last
    chunk ragged), as ``ssd_bounds`` counts the SSD's: per chunk of L rows
    the r·kᵀ scores and their product with v over the L(L+1)/2 pairs
    j <= t (the diagonal carries the bonus u), r·S and the state update
    kᵀ·v, 2 flops a multiply-add, on bf16 tensor cores.  The fp32 time is
    that of the per-step form, which has no matrix product: 5·D² flops a
    step and head (r·S, w·S + k⊗v)."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (3 * B * S * H * D * esize + B * S * H * D * 4 + H * D * 4
              + B * S * H * D * 4 + B * H * D * D * 4 * (2 if with_s0
                                                          else 1))
    flops = 0
    for c0 in range(0, S, 64):
        L = min(64, S - c0)
        flops += 4 * (L * (L + 1) // 2) * D + 4 * L * D * D
    flops *= B * H
    step_flops = 5 * D * D * B * H * S
    return (nbytes, flops, nbytes / H100_BYTES_PER_S * 1e3,
            flops / H100_BF16_FLOPS * 1e3,
            step_flops / H100_FP32_FLOPS * 1e3)


def _wkv_inputs(B, S, H, D, dtype, seed, with_s0=False):
    """The model's layout (B, S, H, D), as ``time_mix`` reshapes its
    projections; logw = -exp(·) in fp32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v = ((rn(B, S, H, D) * 0.5).to(dtype) for _ in range(3))
    logw = -torch.exp(rn(B, S, H, D) * 0.5)
    u = rn(H, D) * 0.3
    return r, k, v, logw, u, (rn(B, H, D, D) * 0.5 if with_s0 else None)


def phase_rwkv6_scan():
    """rwkv6_scan against rwkv6_scan_ref on the card at the rwkv6-7b
    prefill shape and at ragged ones (D 32, a nonzero s0 carried across
    two calls), each variant (bf16: wkv_fwd_mma, fp32: wkv_fwd_simt) at
    least once, bit-identical reruns, and timings of both variants beside
    the bound; returns its kernels-line entry."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter
    for line in ptxas_lines(_build.build_all(["rwkv6_scan"])
                            ["rwkv6_scan"].report):
        log(f"[rwkv6_scan] ptxas: {line}")
    kern, plain = wkv_kernel_adapter("cuda"), wkv_kernel_adapter("torch")
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, D, dtype, s0, split the call at)
    cases = [
        ("rwkv6-7b prefill", *WKV_RWKV6, False, None),
        ("rwkv6-7b prefill, fp32", *WKV_RWKV6[:-1], f32, False, None),
        ("ragged S 1000, D 32", 2, 1000, 8, 32, f32, False, None),
        ("ragged S 1000, D 32, bf16", 2, 1000, 8, 32, bf16, False, None),
        ("s0 carried across two calls (S 45 + 255), D 64", 2, 300, 4, 64,
         bf16, True, 45),
        ("ragged S 77, D 32, s0", 1, 77, 3, 32, bf16, True, None),
        ("S 1, D 64, s0", 3, 1, 2, 64, f32, True, None),
        ("S 1, D 64, s0, bf16", 3, 1, 2, 64, bf16, True, None),
        ("s0 carried across two calls (S 45 + 255), D 64, fp32", 2, 300, 4,
         64, f32, True, 45),
    ]
    max_err = 0.0
    for label, B, S, H, D, dt_, with_s0, split in cases:
        r, k, v, lw, u, s0 = _wkv_inputs(B, S, H, D, dt_, seed=S + H,
                                         with_s0=with_s0)
        if split is None:
            got = kern(r, k, v, lw, u, s0)
        else:
            y1, s1 = kern(r[:, :split], k[:, :split], v[:, :split],
                          lw[:, :split], u, s0)
            y2, s2 = kern(r[:, split:], k[:, split:], v[:, split:],
                          lw[:, split:], u, s1)
            got = (torch.cat([y1, y2], 1), s2)
        again = kern(r, k, v, lw, u, s0)
        torch.cuda.synchronize()
        want = plain(r, k, v, lw, u, s0)
        ey, ry = _check_scan("rwkv6_scan", label, got[0], want[0], WKV_REL)
        es, rs = _check_scan("rwkv6_scan", label + " state", got[1],
                             want[1], WKV_REL)
        same = bool(torch.equal(again[0], kern(r, k, v, lw, u, s0)[0]))
        max_err = max(max_err, ey, es)
        log(f"[rwkv6_scan] {label} (B{B} S{S} H{H} D{D} {str(dt_)[6:]}, "
            f"{WK.VARIANTS[dt_]}, s0 {with_s0}): y max abs err {ey:.3e} "
            f"({ry:.3e} of max(1, "
            f"|y|)), state {es:.3e} ({rs:.3e}); reruns bit-identical "
            f"{same}")
        if not same:
            raise RuntimeError(f"rwkv6_scan {label}: two launches differ")
        del r, k, v, lw, u, s0, got, again, want

    r, k, v, lw, u, _ = _wkv_inputs(*WKV_RWKV6, seed=1)
    r32, k32, v32 = r.float(), k.float(), v.float()
    ms, simt_ms = [], []
    for _ in range(2):             # in turns: mma, SIMT, mma, SIMT
        ms.append(cuda_ms(lambda: kern(r, k, v, lw, u, None), reps=20,
                          warmup=3))
        simt_ms.append(cuda_ms(lambda: kern(r32, k32, v32, lw, u, None),
                               reps=5, warmup=1))
    ms, simt_ms = min(ms), min(simt_ms)
    plain_ms = cuda_ms(lambda: plain(r, k, v, lw, u, None), reps=2,
                       warmup=1)
    nbytes, flops, bytes_ms, bf16_ms, fp32_ms = wkv_bounds(*WKV_RWKV6,
                                                           False)
    bound_ms = max(bytes_ms, bf16_ms)
    log(f"[rwkv6_scan] rwkv6-7b timing: wkv_fwd_mma (bf16) {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms (the per-step oracle), no library call; "
        f"bound {bound_ms * 1e3:.1f} us ({nbytes} bytes at 3.35 TB/s; the "
        f"chunked form's {flops:.4e} flops take {bf16_ms * 1e3:.1f} us on "
        f"bf16 tensor cores); kernel at {bound_ms / ms:.1%} of the bound.  "
        f"wkv_fwd_simt (fp32 r, k, v) {simt_ms:.3f} ms, the per-step "
        f"form's flops {fp32_ms * 1e3:.1f} us at fp32's 67 TFLOP/s "
        f"({fp32_ms / simt_ms:.1%} of it); mma / SIMT {ms / simt_ms:.3f}")
    del r, k, v, lw, u, r32, k32, v32
    return {"name": "rwkv6_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/rwkv6_scan.cu",
            "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:55",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= bf16_ms else "operations",
            "library_ms": None, "at": "rwkv6-7b prefill shape",
            "variant": "mma", "simt_ms": simt_ms}


def timed_run(engine, policy, counters, **run_kw):
    """One run of ``engine`` (``run_kw`` passed to ``run``) with every
    kernel count set to 0 just before it and read just after; returns
    (History, launches, ms per round over rounds 1-5, peak device GiB).  Engines of earlier phases that a
    profile's wrappers hold in reference cycles are collected first, so
    the peak is this run's own."""
    ticks = {}

    def progress(rnd, acc, comm, wall):
        torch.cuda.synchronize()
        ticks[rnd] = time.perf_counter()

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    hist = engine.run(policy, progress=progress, **run_kw)
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
              {"fed_agg": 1, "residual_norms": 0, **SERVE_ONLY},
              data.num_classes)
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


# the dynamics runs: (label, scenario preset or None, FLConfig changes,
# launches per round of each kernel).  The flude runs aggregate by the
# mean (one fed_agg a round); the sign-flip-20 scenario runs
# geometric_median, as [robust] does
MEAN_ONLY = {"fed_agg": 1, "residual_norms": 0, **SERVE_ONLY}
DYNAMICS_RUNS = [
    ("bernoulli depth 1", None, dict(dynamics="bernoulli"), MEAN_ONLY),
    ("bernoulli depth 2", None, dict(dynamics="bernoulli",
                                     pipeline_depth=2), MEAN_ONLY),
    ("churn", "churn", {}, MEAN_ONLY),
    ("diurnal", "diurnal", {}, MEAN_ONLY),
    ("flash-crowd", "flash-crowd", {}, MEAN_ONLY),
    ("sign-flip-20 geometric_median", "sign-flip-20",
     dict(agg_rule="geometric_median"), ROBUST_RUNS[0][3]),
]


def _dynamics_config(scenario, changes, **base):
    """``FLConfig(**base, **changes)`` with the scenario preset applied."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.fleet import apply_scenario
    fl = FLConfig(**base, **changes)
    return fl if scenario is None else apply_scenario(fl, scenario)


def phase_dynamics(data, counters):
    """The device dynamics loop (``FLConfig.dynamics`` a device process)
    at the main path's size: the runs of ``DYNAMICS_RUNS``, each timed
    with its launches read across it; depths 1 and 2 held to identical
    History rows; a depth-2 run under sync debug mode "error"; the card
    against the CPU; a profiled short run of the depth-2 engine.  Returns
    each run's launches, History rows and peak device GiB."""
    from repro_torch.fl import FleetEngine, SimConfig
    sim = SimConfig(num_clients=MAIN_N, rounds=MAIN_ROUNDS)
    out, rows, peaks = {}, {}, {}
    # one engine alive at a time, so each peak is its own
    for label, scenario, changes, per_round in DYNAMICS_RUNS:
        t0 = time.perf_counter()
        fl = _dynamics_config(scenario, changes, num_clients=MAIN_N,
                              clients_per_round=MAIN_PER_ROUND,
                              agg_impl="cuda")
        engine = FleetEngine(data, sim, fl)
        setup = time.perf_counter() - t0
        hist, launches, ms, peak = timed_run(engine, "flude", counters)
        log(f"[dynamics] {label} (flude, {fl.dynamics} "
            f"{dict(fl.dynamics_params)}, depth {fl.pipeline_depth}, agg "
            f"{fl.agg_rule}, adversary {fl.adversary}): engine set-up "
            f"{setup:.1f} s; selected {hist.selected}; received "
            f"{hist.received}; acc {hist.acc}")
        log(f"[dynamics] {label}: {ms:.1f} ms/round over rounds 1-"
            f"{MAIN_ROUNDS - 1}, peak device memory {peak:.2f} GiB, "
            f"launches {launches}")
        check_run(f"dynamics {label}", hist, launches, per_round,
                  data.num_classes)
        out[f"dynamics {label}"] = launches
        rows[label] = hist.to_json()
        peaks[label] = peak
        if label == "bernoulli depth 2":
            same = rows["bernoulli depth 1"] == rows[label]
            log(f"[dynamics] bernoulli History rows at depths 1 and 2 "
                f"identical: {same}")
            if not same:
                raise RuntimeError(
                    f"dynamics: depth 1 and depth 2 rows differ: "
                    f"{rows['bernoulli depth 1']} vs {rows[label]}")
            check_no_sync(engine, data.num_classes, "dynamics",
                          "bernoulli, depth 2")
            phase_profile(engine, "flude",
                          "dynamics profile bernoulli depth 2")
        del engine, hist
    phase_dynamics_card_vs_cpu()
    return out, rows, peaks


def check_no_sync(engine, num_classes, tag, label, **run_kw):
    """One flude run of a (warm) engine under ``torch.cuda`` sync debug
    mode "error": any wait for the card outside the ledger's resolve, the
    run-end read-back, the offload stream's two reads a round and the
    ``debug_checks`` guard's read (all through ``host_readback``)
    raises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hist = engine.run("flude", diagnostics=False, **run_kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[{tag}] no-sync run ({label}, sync debug mode 'error'): "
        f"{MAIN_ROUNDS} rounds in {(time.perf_counter() - t0) * 1e3:.1f} "
        f"ms, no synchronisation outside host_readback; selected "
        f"{hist.selected}, received {hist.received}")
    check_run(f"{tag} no-sync", hist, {}, {}, num_classes)


def phase_dynamics_card_vs_cpu():
    """N = 24, 5 rounds of flude under churn on the card and on the CPU
    from the same dynamics and explore uniforms, drawn once on the CPU:
    selected, received and comm identical, wall clock within 1e-5,
    accuracy within ACC_TOL."""
    import repro_torch.fl as F
    from repro_torch.data.synthetic import federated_classification
    from repro_torch.fleet import draw_noise, get_dynamics
    n, rounds = 24, 5
    data = federated_classification(n, seed=2, margin=1.3, noise=1.3,
                                    n_per_client=32)
    sim = F.SimConfig(num_clients=n, rounds=rounds, seed=3, local_steps=4)
    fl = _dynamics_config("churn", {}, num_clients=n, clients_per_round=8)
    proc = get_dynamics(fl.dynamics)
    gen = torch.Generator().manual_seed(0)
    noise = {"init": draw_noise(proc.init_noise, n, gen, "cpu")}
    for rnd in range(rounds):
        noise[rnd] = draw_noise(proc.step_noise, n, gen, "cpu")
    us = [torch.rand((n,), generator=gen) for _ in range(rounds)]
    cpu, card = (F.FleetEngine(data, sim, fl, device=d).run(
        "flude", explore_uniforms=lambda r: us[r],
        dynamics_noise=lambda r: noise[r]) for d in ("cpu", "cuda"))
    wall = max(abs(a - b) for a, b in zip(cpu.wall_clock, card.wall_clock))
    acc = max(abs(a - b) for a, b in zip(cpu.acc, card.acc))
    log(f"[dynamics card vs CPU] churn, N={n}, {rounds} rounds: cpu "
        f"selected {cpu.selected} received {cpu.received}; card acc "
        f"{card.acc}; max |card - cpu| wall clock {wall:.3e}, acc "
        f"{acc:.6f}")
    if (cpu.selected, cpu.received, cpu.comm_mb) != \
            (card.selected, card.received, card.comm_mb):
        raise RuntimeError(f"dynamics card vs CPU: trajectories differ: "
                           f"{card.to_json()} vs {cpu.to_json()}")
    if wall > 1e-5 or acc > ACC_TOL:
        raise RuntimeError(f"dynamics card vs CPU: wall clock differs by "
                           f"{wall}, accuracy by {acc}")


# the compact-cohort runs at the main path's fleet: (label, FLConfig
# changes, launches per round of each kernel).  X = 512 = clients per
# round, under bernoulli availability
COHORT_BASE = dict(dynamics="bernoulli", cohort_size=COHORT_X)
COHORT_RUNS = [
    ("resident depth 1", {}, MEAN_ONLY),
    ("resident depth 2", dict(pipeline_depth=2), MEAN_ONLY),
    ("host offload", dict(cache_offload="host"), MEAN_ONLY),
    ("discard bound 1", dict(cache_offload="discard",
                             cache_staleness_bound=1), MEAN_ONLY),
    ("sign-flip-20 geometric_median", dict(agg_rule="geometric_median",
                                           **ATTACK), ROBUST_RUNS[0][3]),
]


# the [dynamics] run each cohort run is held to: same fleet, seeds and
# rule over all N rows
FULL_SCAN_TWIN = {"resident depth 1": "bernoulli depth 1",
                  "sign-flip-20 geometric_median":
                      "sign-flip-20 geometric_median"}


def phase_cohort(data, counters, dyn_rows, dyn_peaks):
    """Compact cohorts and host cache offload on the device loop at the
    main path's fleet (N = 4096, X = 512): the runs of ``COHORT_RUNS``,
    each timed with its launches read across it and its engine freed
    before the next.  Held: rows at depths 1 and 2 identical, host
    offload rows identical to resident rows, the resident run and the
    sign-flip-20 run against their ``[dynamics]`` twins (selected,
    received, comm exact, accuracy within ACC_TOL), one fed_agg launch a round, each peak at
    most the full scan's, the stream's copies (none synchronous, X·D
    bytes a round each way), a no-sync run of the cohort engine and of
    the offload engine, and card = CPU at N = 32.  Returns each run's
    launches."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.fl import FleetEngine, SimConfig
    from repro_torch.kernels.fed_agg.kernel import chunk_rows, geometry
    for d in (MAIN_D, D_1M):
        g = geometry(COHORT_X, d)
        sizes = [b - a for a, b in (chunk_rows(g, COHORT_X, 8, i)
                                    for i in range(g.n_chunks))]
        log(f"[cohort] fed_agg at ({COHORT_X}, {d}): {g.col_blocks} x "
            f"{g.n_chunks} blocks, chunks of {sorted(set(sizes))} rows")
        if sum(sizes) != COHORT_X or any(n % 8 for n in sizes):
            raise RuntimeError(f"cohort: fed_agg splits {COHORT_X} rows "
                               f"into {sizes}, not whole block_c chunks")
    sim = SimConfig(num_clients=MAIN_N, rounds=MAIN_ROUNDS)
    out, rows = {}, {}
    for label, changes, per_round in COHORT_RUNS:
        t0 = time.perf_counter()
        fl = FLConfig(num_clients=MAIN_N, clients_per_round=MAIN_PER_ROUND,
                      agg_impl="cuda", **COHORT_BASE, **changes)
        engine = FleetEngine(data, sim, fl)
        setup = time.perf_counter() - t0
        hist, launches, ms, peak = timed_run(engine, "flude", counters)
        stats = engine.transfer_stats.snapshot()
        log(f"[cohort] {label} (flude, X={fl.cohort_size}, depth "
            f"{fl.pipeline_depth}, offload {fl.cache_offload}, agg "
            f"{fl.agg_rule}, adversary {fl.adversary}): engine set-up "
            f"{setup:.1f} s; selected {hist.selected}; received "
            f"{hist.received}; acc {hist.acc}")
        log(f"[cohort] {label}: {ms:.1f} ms/round over rounds 1-"
            f"{MAIN_ROUNDS - 1}, peak device memory {peak:.2f} GiB "
            f"([dynamics] bernoulli depth 1: "
            f"{dyn_peaks['bernoulli depth 1']:.2f}), launches {launches}, "
            f"transfers {stats}")
        check_run(f"cohort {label}", hist, launches, per_round,
                  data.num_classes)
        if peak > dyn_peaks["bernoulli depth 1"]:
            raise RuntimeError(f"cohort {label}: peak {peak:.3f} GiB above "
                               f"the full scan's")
        out[f"cohort {label}"] = launches
        rows[label] = hist.to_json()
        if fl.cache_offload is not None:
            mem = engine.server_step_memory()
            row = engine.cache_store.row_bytes
            log(f"[cohort] {label}: store {len(engine.cache_store)} rows "
                f"({mem['cache_host_bytes']} bytes), {engine.cache_store.pruned}"
                f" rows pruned; device cache {mem['cache_device_bytes']} "
                f"bytes")
            want = {"h2d_async": MAIN_ROUNDS, "d2h_async": 2 * MAIN_ROUNDS,
                    "h2d_bytes": MAIN_ROUNDS * COHORT_X * row,
                    "d2h_bytes": MAIN_ROUNDS * COHORT_X * (row + 24),
                    "pre_issued_reads": 2 * MAIN_ROUNDS, "sync_copies": 0}
            if stats != want:
                raise RuntimeError(f"cohort {label}: transfers {stats}, "
                                   f"expected {want}")
            if fl.cache_offload == "discard" \
                    and engine.cache_store.pruned == 0:
                raise RuntimeError("cohort discard: the bound pruned no row")
        if label in FULL_SCAN_TWIN:
            twin = FULL_SCAN_TWIN[label]
            ref = dyn_rows[twin]
            same = [ref[k] == rows[label][k]
                    for k in ("selected", "received", "comm_mb")]
            acc = max(abs(a - b) for a, b in zip(ref["acc"],
                                                 rows[label]["acc"]))
            log(f"[cohort] {label} against [dynamics] {twin}: selected / "
                f"received / comm equal {same}, max |acc difference| "
                f"{acc:.6f}, History rows identical {ref == rows[label]}")
            if not all(same) or acc > ACC_TOL:
                raise RuntimeError(f"cohort {label} against the full scan: "
                                   f"{rows[label]} vs {ref}")
        if label == "resident depth 2":
            if rows[label] != rows["resident depth 1"]:
                raise RuntimeError(f"cohort: depth 1 and depth 2 rows "
                                   f"differ: {rows['resident depth 1']} vs "
                                   f"{rows[label]}")
            log("[cohort] rows at depths 1 and 2 identical: True")
            check_no_sync(engine, data.num_classes, "cohort",
                          "resident, depth 2")
            phase_profile(engine, "flude", "cohort profile resident depth 2")
        if label == "host offload":
            if rows[label] != rows["resident depth 1"]:
                raise RuntimeError(f"cohort: host offload rows differ from "
                                   f"resident rows: {rows[label]} vs "
                                   f"{rows['resident depth 1']}")
            log("[cohort] host offload rows identical to resident: True")
            check_no_sync(engine, data.num_classes, "cohort",
                          "host offload, depth 1")
            if engine.transfer_stats.sync_copies:
                raise RuntimeError("cohort: a synchronous copy")
            # the timed run above was the engine's first: its store grew
            # from empty.  A later run starts from a cleared store
            again, _, ms2, _ = timed_run(engine, "flude", counters)
            log(f"[cohort] host offload, a later run of the same engine: "
                f"{ms2:.1f} ms/round over rounds 1-{MAIN_ROUNDS - 1}; rows "
                f"identical {again.to_json() == rows[label]}")
            phase_profile(engine, "flude", "cohort profile host offload")
        del engine, hist
    phase_cohort_card_vs_cpu()
    return out


def phase_cohort_card_vs_cpu():
    """N = 32, X = 8, 4 rounds of flude under markov, resident and host
    offload, on the card and on the CPU from the same uniforms drawn once
    on the CPU: selected, received and comm identical, wall clock within
    1e-5, accuracy within ACC_TOL."""
    import repro_torch.fl as F
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import federated_classification
    from repro_torch.fleet import draw_noise, get_dynamics
    n, rounds = 32, 4
    data = federated_classification(n, seed=4, n_per_client=16)
    sim = F.SimConfig(num_clients=n, rounds=rounds, seed=3, local_steps=2,
                      batch_size=8)
    proc = get_dynamics("markov")
    gen = torch.Generator().manual_seed(0)
    noise = {"init": draw_noise(proc.init_noise, n, gen, "cpu")}
    for rnd in range(rounds):
        noise[rnd] = draw_noise(proc.step_noise, n, gen, "cpu")
    us = [torch.rand((n,), generator=gen) for _ in range(rounds)]
    for offload in (None, "host"):
        fl = FLConfig(num_clients=n, clients_per_round=8, dynamics="markov",
                      cohort_size=8, cache_offload=offload)
        cpu, card = (F.FleetEngine(data, sim, fl, device=d).run(
            "flude", explore_uniforms=lambda r: us[r],
            dynamics_noise=lambda r: noise[r]) for d in ("cpu", "cuda"))
        wall = max(abs(a - b) for a, b in zip(cpu.wall_clock,
                                               card.wall_clock))
        acc = max(abs(a - b) for a, b in zip(cpu.acc, card.acc))
        log(f"[cohort card vs CPU] offload {offload}, N={n}, X=8: cpu "
            f"selected {cpu.selected} received {cpu.received}; card acc "
            f"{card.acc}; max |card - cpu| wall clock {wall:.3e}, acc "
            f"{acc:.6f}")
        if (cpu.selected, cpu.received, cpu.comm_mb) != \
                (card.selected, card.received, card.comm_mb):
            raise RuntimeError(f"cohort card vs CPU: trajectories differ: "
                               f"{card.to_json()} vs {cpu.to_json()}")
        if wall > 1e-5 or acc > ACC_TOL:
            raise RuntimeError(f"cohort card vs CPU: wall clock differs by "
                               f"{wall}, accuracy by {acc}")


# the telemetry="full" round on the device loop: the server step's mean
# and update_norm's fed_agg, plus its two residual_norms passes
TELEMETRY_FULL = {"fed_agg": 2, "residual_norms": 2, **SERVE_ONLY}
# History.metrics of the card against the CPU on the same noise, stated
# before the first run: counts exact; floats within METRIC_CARD_TOL of
# max(1, |cpu value|), agg_residual_* within it of max(1,
# update_norm_max) (the trainers' fp32 sums run in other orders)
METRIC_CARD_TOL = 1e-4
METRIC_INTS = ("selected_count", "received_count", "interrupted_count",
               "online_count", "download_count", "cache_rows",
               "cache_hit_count", "cache_expired_count", "staleness_hist")


def _device_loop_fl(**changes):
    from repro_torch.configs.base import FLConfig
    return FLConfig(num_clients=MAIN_N, clients_per_round=MAIN_PER_ROUND,
                    agg_impl="cuda", dynamics="bernoulli", **changes)


def _rows_of(hist):
    """A History's rows without its metric columns."""
    d = hist.to_json()
    d.pop("metrics", None)
    return d


def _handed_noise(process, n, rounds, seed=0):
    """Dynamics and explore uniforms for a card-against-CPU run, drawn
    once on the CPU."""
    from repro_torch.fleet import draw_noise, get_dynamics
    proc = get_dynamics(process)
    gen = torch.Generator().manual_seed(seed)
    noise = {"init": draw_noise(proc.init_noise, n, gen, "cpu")}
    for rnd in range(rounds):
        noise[rnd] = draw_noise(proc.step_noise, n, gen, "cpu")
    us = [torch.rand((n,), generator=gen) for _ in range(rounds)]
    return noise, us


def _check_card_vs_cpu(tag, label, cpu, card):
    """Selected, received and comm identical, wall clock within 1e-5,
    accuracy within ACC_TOL."""
    wall = max(abs(a - b) for a, b in zip(cpu.wall_clock, card.wall_clock))
    acc = max(abs(a - b) for a, b in zip(cpu.acc, card.acc))
    log(f"[{tag}] {label}: cpu selected {cpu.selected} received "
        f"{cpu.received}; card acc {card.acc}; max |card - cpu| wall "
        f"clock {wall:.3e}, acc {acc:.6f}")
    if (cpu.selected, cpu.received, cpu.comm_mb) != \
            (card.selected, card.received, card.comm_mb):
        raise RuntimeError(f"{tag}: trajectories differ: "
                           f"{card.to_json()} vs {cpu.to_json()}")
    if wall > 1e-5 or acc > ACC_TOL:
        raise RuntimeError(f"{tag}: wall clock differs by {wall}, "
                           f"accuracy by {acc}")


def phase_thompson(data, counters):
    """Thompson selection on the device loop at the main path's fleet
    (N = 4096, 512 a round, bernoulli) with the port's CUDA sampler:
    ``"mean"`` and ``"thompson"`` engines timed in turns (mean, thompson,
    thompson, mean), one fed_agg launch a round each; |S| = min(X,
    |online|) every round (a ``telemetry="basic"`` run reads the online
    count, its rows identical to the timed run's); the sampler's device
    time at N; then N = 24 on the card against the CPU with handed-in
    draws.  Returns the Thompson run's launches."""
    from repro_torch.core.dependability import (BetaBelief,
                                                sample_dependability)
    from repro_torch.fl import FleetEngine, SimConfig
    sim = SimConfig(num_clients=MAIN_N, rounds=MAIN_ROUNDS)
    engines = {m: FleetEngine(data, sim, _device_loop_fl(selection_mode=m))
               for m in ("mean", "thompson")}
    ms = {"mean": [], "thompson": []}
    hists = {}
    for mode in ("mean", "thompson", "thompson", "mean"):
        hist, launches, t, _ = timed_run(engines[mode], "flude", counters)
        check_run(f"thompson {mode}", hist, launches, MEAN_ONLY,
                  data.num_classes)
        ms[mode].append(t)
        hists[mode] = hist
        if mode == "thompson":
            th_launches = launches
    th = hists["thompson"]
    log(f"[thompson] N={MAIN_N}, {MAIN_PER_ROUND} a round, bernoulli, "
        f"depth 1: ms/round mean {ms['mean']}, thompson {ms['thompson']} "
        f"(in turns); thompson selected {th.selected}, received "
        f"{th.received}, acc {th.acc}; launches {th_launches}")
    basic = engines["thompson"].run("flude", telemetry="basic")
    online = basic.metrics["online_count"]
    log(f"[thompson] online {online}, selected {basic.selected}; "
        f"part_count differs from the mean run's: "
        f"{bool((th.part_count != hists['mean'].part_count).any())}")
    for s, on in zip(basic.selected, online):
        if s != min(MAIN_PER_ROUND, on):
            raise RuntimeError(f"thompson: selected {s} of {on} online, "
                               f"expected min({MAIN_PER_ROUND}, {on})")
    if _rows_of(basic) != _rows_of(th):
        raise RuntimeError("thompson: the telemetry run's rows differ from "
                           "the timed run's")
    g = torch.Generator(device="cuda").manual_seed(0)
    ab = torch.rand((2, MAIN_N), generator=g, device="cuda") * 40 + 0.5
    belief = BetaBelief(ab[0], ab[1])
    sample_ms = cuda_ms(lambda: sample_dependability(belief, g))
    log(f"[thompson] sampler at N={MAIN_N}: {sample_ms * 1e3:.1f} us of "
        f"device time a draw")
    del engines
    phase_thompson_card_vs_cpu()
    return {"thompson": th_launches}


def phase_thompson_card_vs_cpu():
    """N = 24, 5 rounds of flude under Thompson (markov) on the card and
    on the CPU with the same handed-in dynamics noise, explore uniforms
    and Beta draws (sampled on the CPU from each round's beliefs)."""
    import repro_torch.fl as F
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.dependability import (BetaBelief,
                                                sample_dependability)
    from repro_torch.data.synthetic import federated_classification
    n, rounds = 24, 5
    data = federated_classification(n, seed=2, margin=1.3, noise=1.3,
                                    n_per_client=32)
    sim = F.SimConfig(num_clients=n, rounds=rounds, seed=3, local_steps=4)
    fl = FLConfig(num_clients=n, clients_per_round=8, dynamics="markov",
                  selection_mode="thompson")
    noise, us = _handed_noise("markov", n, rounds)

    def draws(rnd, alpha, beta):
        gen = torch.Generator().manual_seed(100 + rnd)
        return sample_dependability(BetaBelief(alpha.cpu(), beta.cpu()),
                                    gen)
    cpu, card = (F.FleetEngine(data, sim, fl, device=d).run(
        "flude", explore_uniforms=lambda r: us[r],
        dynamics_noise=lambda r: noise[r], thompson_draws=draws)
        for d in ("cpu", "cuda"))
    _check_card_vs_cpu("thompson card vs CPU", f"markov, N={n}, {rounds} "
                       f"rounds, handed-in draws", cpu, card)


def phase_telemetry(data, counters, dyn_rows):
    """Telemetry on the device loop at the main path's fleet (N = 4096,
    D = 22,026, bernoulli, depth 2, flude), full scan and a cohort of X =
    512: ``telemetry=False`` and ``"full"`` runs in turns, three each,
    rows identical (the full scan's also to ``[dynamics] bernoulli depth
    2``), each full round one more fed_agg and two residual_norms
    launches (update_norm at (512, 22,026)); the tracer's host time of
    the metrics span; the metrics against an ``agg_impl="torch"`` twin
    on the card; a ``"full"`` run under sync debug mode "error";
    then N = 32 on the card against the CPU for History.metrics.
    Returns each path's launches."""
    from repro_torch.fl import FleetEngine, SimConfig
    from repro_torch.obs import Telemetry
    sim = SimConfig(num_clients=MAIN_N, rounds=MAIN_ROUNDS)
    out = {}
    for label, changes in (("full scan", {}),
                           ("cohort", dict(cohort_size=COHORT_X))):
        engine = FleetEngine(data, sim, _device_loop_fl(pipeline_depth=2,
                                                        **changes))
        ms, rows, spans = {"off": [], "full": []}, None, []
        for level in ("off", "full") * 3:
            tel = False if level == "off" else Telemetry(level="full")
            hist, launches, t, _ = timed_run(engine, "flude", counters,
                                             telemetry=tel)
            check_run(f"telemetry {label} {level}", hist, launches,
                      MEAN_ONLY if level == "off" else TELEMETRY_FULL,
                      data.num_classes)
            ms[level].append(t)
            if rows is None:
                rows = _rows_of(hist)
            elif _rows_of(hist) != rows:
                raise RuntimeError(f"telemetry {label}: {level} rows "
                                   f"differ: {_rows_of(hist)} vs {rows}")
            if level == "full":
                full, full_launches = hist, launches
                spans.append(tel.tracer.summary()["metrics"]["mean_s"])
        if label == "full scan" and rows != dyn_rows["bernoulli depth 2"]:
            raise RuntimeError("telemetry: rows differ from [dynamics] "
                               "bernoulli depth 2")
        m = full.metrics
        if m["selected_count"] != full.selected \
                or m["received_count"] != full.received \
                or not all(math.isfinite(v) for v in
                           m["update_norm_mean"] + m["agg_residual_max"]):
            raise RuntimeError(f"telemetry {label}: metrics {m}")
        log(f"[telemetry] {label}: ms/round off {ms['off']}, full "
            f"{ms['full']} (in turns); rows identical off and on: True; "
            f"metrics span host {[round(s * 1e3, 3) for s in spans]} "
            f"ms/round; launches (full) {full_launches}")
        log(f"[telemetry] {label}: update_norm_mean "
            f"{[round(v, 5) for v in m['update_norm_mean']]}, "
            f"agg_residual_mean "
            f"{[round(v, 5) for v in m['agg_residual_mean']]}, "
            f"local_loss_mean {[round(v, 4) for v in m['local_loss_mean']]}")
        phase_telemetry_plain_twin(data, sim, engine.fl_cfg, label, full)
        check_no_sync(engine, data.num_classes, "telemetry",
                      f"{label}, depth 2, telemetry full",
                      telemetry="full")
        out[f"telemetry {label}"] = full_launches
        del engine
    phase_telemetry_card_vs_cpu()
    return out


def phase_telemetry_plain_twin(data, sim, fl, label, full):
    """The same engine config with ``agg_impl="torch"`` on the card, one
    ``"full"`` run: the same rows as the kernel run ``full`` (selected,
    received, wall clock, comm exact) and History.metrics within the
    bounds of ``metric_gaps`` — the received rows' gather (cohort_index,
    take_rows, pack_stacked at rows_bound 512) held at full width, not
    only the kernels."""
    from repro_torch.fl import FleetEngine
    plain = FleetEngine(data, sim, dataclasses.replace(
        fl, agg_impl="torch")).run("flude", telemetry="full")
    tag = f"telemetry {label} plain twin"
    for key in ("selected", "received", "wall_clock", "comm_mb"):
        if getattr(plain, key) != getattr(full, key):
            raise RuntimeError(f"{tag}: {key} {getattr(full, key)} vs "
                               f"plain {getattr(plain, key)}")
    gaps = metric_gaps(plain.metrics, full.metrics)
    log(f"[{tag}] {len(gaps)} metric columns against agg_impl=\"torch\" "
        f"on the card, largest gap over its bound "
        f"{max(gaps.values()):.3f} ({max(gaps, key=gaps.get)})")
    if set(plain.metrics) != set(full.metrics) \
            or max(gaps.values()) > 1.0:
        raise RuntimeError(f"{tag}: metrics differ: {gaps}")


def metric_gaps(cpu, card):
    """Per column: the largest gap of the card's metric values to the
    CPU's over its bound (<= 1 holds), counts exact."""
    worst = {}
    norm = [max(1.0, v) for v in cpu["update_norm_max"]] \
        if "update_norm_max" in cpu else None
    for name, want in cpu.items():
        got = card[name]
        if name in METRIC_INTS:
            worst[name] = 0.0 if got == want else math.inf
            continue
        flat_w, flat_g, scale = [], [], []
        for r, (w, g) in enumerate(zip(want, got)):
            w = w if isinstance(w, list) else [w]
            g = g if isinstance(g, list) else [g]
            flat_w += w
            flat_g += g
            scale += [norm[r] if name.startswith("agg_residual")
                      else max(1.0, abs(x)) for x in w]
        worst[name] = max(abs(a - b) / (METRIC_CARD_TOL * s)
                          for a, b, s in zip(flat_g, flat_w, scale))
    return worst


def phase_telemetry_card_vs_cpu():
    """N = 32, 4 rounds of flude under markov with telemetry "full" on
    the card and on the CPU from the same uniforms: the trajectories as
    in ``[dynamics card vs CPU]``, History.metrics within the bounds of
    ``metric_gaps``.  Full scan (mean) and a cohort of 8 under the trust
    rule (trust quantiles)."""
    import repro_torch.fl as F
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import federated_classification
    n, rounds = 32, 4
    data = federated_classification(n, seed=4, n_per_client=16)
    sim = F.SimConfig(num_clients=n, rounds=rounds, seed=3, local_steps=2,
                      batch_size=8)
    noise, us = _handed_noise("markov", n, rounds)
    for label, changes in (("full scan", {}),
                           ("cohort 8, trust", dict(cohort_size=8,
                                                    agg_rule="trust"))):
        fl = FLConfig(num_clients=n, clients_per_round=8, dynamics="markov",
                      telemetry="full", **changes)
        cpu, card = (F.FleetEngine(data, sim, fl, device=d).run(
            "flude", explore_uniforms=lambda r: us[r],
            dynamics_noise=lambda r: noise[r]) for d in ("cpu", "cuda"))
        tag = "telemetry card vs CPU"
        _check_card_vs_cpu(tag, f"{label}, N={n}", cpu, card)
        gaps = metric_gaps(cpu.metrics, card.metrics)
        log(f"[{tag}] {label}: {len(gaps)} metric columns, largest gap "
            f"over its bound {max(gaps.values()):.3f} "
            f"({max(gaps, key=gaps.get)})")
        if set(card.metrics) != set(cpu.metrics) \
                or max(gaps.values()) > 1.0:
            raise RuntimeError(f"{tag}: metrics differ: {gaps}")


def phase_debug_checks(data, counters, dyn_rows):
    """``debug_checks`` on the device loop at the main path's fleet
    (bernoulli, depth 2): checked and unchecked engines timed in turns,
    rows identical to each other and to ``[dynamics] bernoulli depth 2``;
    a checked run under sync debug mode "error" whose guard reads, one a
    round, all go through ``host_readback``; the guard fired by a card
    tensor holding a NaN.  Returns the checked run's launches."""
    from repro_torch.analysis import runtime as RT
    from repro_torch.fl import FleetEngine, SimConfig
    sim = SimConfig(num_clients=MAIN_N, rounds=MAIN_ROUNDS)
    engines = {c: FleetEngine(data, sim, _device_loop_fl(
        pipeline_depth=2, debug_checks=c)) for c in (False, True)}
    ms = {False: [], True: []}
    for checked in (False, True, True, False):
        hist, launches, t, _ = timed_run(engines[checked], "flude",
                                         counters)
        check_run(f"debug_checks {checked}", hist, launches, MEAN_ONLY,
                  data.num_classes)
        ms[checked].append(t)
        if _rows_of(hist) != dyn_rows["bernoulli depth 2"]:
            raise RuntimeError(f"debug_checks {checked}: rows differ from "
                               f"[dynamics] bernoulli depth 2")
        if checked:
            checked_launches = launches
    reads = []
    real = RT.host_readback

    def counting(device):
        reads.append(1)
        return real(device)

    RT.host_readback = counting
    try:
        check_no_sync(engines[True], data.num_classes, "debug_checks",
                      "depth 2, debug_checks")
    finally:
        RT.host_readback = real
    log(f"[debug_checks] ms/round unchecked {ms[False]}, checked "
        f"{ms[True]} (in turns); rows identical: True; guard reads in "
        f"the no-sync run {len(reads)} (one a round, through "
        f"host_readback)")
    if len(reads) != MAIN_ROUNDS:
        raise RuntimeError(f"debug_checks: {len(reads)} guard reads in "
                           f"{MAIN_ROUNDS} rounds")
    guard = RT.make_round_guard(MAIN_N, with_idx=False)
    flags = guard({"w": torch.tensor([1.0, math.nan], device="cuda")},
                  torch.zeros(4, device="cuda"))
    try:
        RT.check_round(flags, guard.messages, 7, "cuda")
    except RT.RoundCheckError as e:
        log(f"[debug_checks] guard on a card tensor holding a NaN: {e}")
    else:
        raise RuntimeError("debug_checks: the guard let a NaN through")
    return {"debug_checks": checked_launches}


def million_client_data(n, *, num_classes=2, dim=4, n_per_client=2,
                        n_test=256, seed=0):
    """The reference smoke's vectorised tiny task
    (``benchmarks/bench_engine.py:391-405``): ``federated_classification``
    loops over clients in Python, which at N = 1M would dwarf the run."""
    import numpy as np
    from repro_torch.data.synthetic import FederatedClassification
    rng = np.random.RandomState(seed)
    centers = (rng.randn(num_classes, dim) * 2.2).astype(np.float32)
    y = rng.randint(0, num_classes, (n, n_per_client))
    x = centers[y] + rng.randn(n, n_per_client, dim).astype(np.float32)
    ty = rng.randint(0, num_classes, n_test)
    tx = centers[ty] + rng.randn(n_test, dim).astype(np.float32)
    return FederatedClassification(x, y.astype(np.int32), tx,
                                   ty.astype(np.int32),
                                   y[:, :1].astype(np.int32), num_classes)


def phase_cohort_1m(counters):
    """The reference's million-client smoke at full width: N = 1M, X =
    512, the default classifier (D = 17,410), cache_offload="host".  A
    one-round warm-up, then 3 timed rounds with the counts read across
    them; the device cache must be (N,) metadata plus one (X, D) block.
    The host store stays empty under FLUDE here (``check_1m_write_back``
    shows the write-back at this N through SAFA).  Returns the FLUDE
    run's launches."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.fl import FleetEngine, SimConfig
    t0 = time.perf_counter()
    data = million_client_data(N_1M, seed=8)
    sim = SimConfig(num_clients=N_1M, rounds=ROUNDS_1M, local_steps=2,
                    batch_size=2, seed=7)
    fl = FLConfig(num_clients=N_1M, clients_per_round=COHORT_X,
                  cohort_size=COHORT_X, dynamics="bernoulli",
                  cache_offload="host", agg_impl="cuda")
    engine = FleetEngine(data, sim, fl)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.run("flude", rounds=1, diagnostics=False)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    engine.transfer_stats.reset()
    for c in counters.values():
        c.reset()
    ticks = {}

    def progress(rnd, acc, comm, wall):
        torch.cuda.synchronize()
        ticks[rnd] = time.perf_counter()

    t0 = time.perf_counter()
    hist = engine.run("flude", diagnostics=False, progress=progress)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    last = ROUNDS_1M - 1
    ms = (ticks[last] - ticks[0]) * 1e3 / last
    launches = {name: c.count for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    stats = engine.transfer_stats.snapshot()
    mem = engine.server_step_memory()
    row = engine.cache_store.row_bytes
    want_dev = N_1M * 8 + COHORT_X * row
    log(f"[cohort 1M] N={N_1M}, X={COHORT_X}, D={row // 4}: data + engine "
        f"set-up {setup:.1f} s, warm-up round {warm:.2f} s; selected "
        f"{hist.selected}; received {hist.received}; acc {hist.acc}")
    log(f"[cohort 1M] {ms:.1f} ms/round over rounds 1-{last} ({run_s:.2f} s "
        f"for the {ROUNDS_1M}-round run, its set-up included); cache on the device {mem['cache_device_bytes']}"
        f" bytes, on the host {mem['cache_host_bytes']} bytes "
        f"({len(engine.cache_store)} rows); resident equivalent "
        f"{N_1M * row} bytes; max_memory_allocated {peak} bytes; "
        f"server step peak_live_bytes {mem['peak_live_bytes']}; launches "
        f"{launches}; transfers {stats}")
    if row != D_1M * 4 or mem["cache_device_bytes"] != want_dev \
            or want_dev != 43_655_680:
        raise RuntimeError(f"cohort 1M: device cache "
                           f"{mem['cache_device_bytes']} bytes, row {row}; "
                           f"expected 43,655,680 and {D_1M * 4}")
    if launches["fed_agg"] != ROUNDS_1M or stats["sync_copies"] \
            or stats["h2d_bytes"] != ROUNDS_1M * COHORT_X * row:
        raise RuntimeError(f"cohort 1M: launches {launches}, transfers "
                           f"{stats}")
    for s, r in zip(hist.selected, hist.received):
        if not 1 <= r <= s <= COHORT_X:
            raise RuntimeError(f"cohort 1M: received {r}, selected {s}")
    if not all(math.isfinite(a) for a in hist.acc):
        raise RuntimeError(f"cohort 1M: accuracy {hist.acc}")
    if mem["cache_host_bytes"] != len(engine.cache_store) * row:
        raise RuntimeError(f"cohort 1M: {mem['cache_host_bytes']} host "
                           f"cache bytes for {len(engine.cache_store)} rows")
    check_1m_write_back(engine)
    del engine, data
    gc.collect()
    return launches


def check_1m_write_back(engine):
    """FLUDE writes no cache row at 2 local steps (its hints pick devices
    whose cache interval is 3-4 steps), so the write-back at N = 1M is
    shown by a SAFA run of the same engine (random online clients, some
    with an interval of 1-2 steps): the store must hold rows, each
    finite and non-zero, and the host bytes must count them."""
    import numpy as np
    store = engine.cache_store
    hist = engine.run("safa", diagnostics=False)
    torch.cuda.synchronize()
    mem = engine.server_step_memory()
    ids = np.array([i for i in range(store.num_clients)
                    if store.stamp_of(i) is not None], np.int64)
    block = store.pack(store.gather(ids)) if len(ids) else None
    log(f"[cohort 1M] safa, {ROUNDS_1M} rounds: selected {hist.selected};"
        f" received {hist.received}; store {len(store)} rows "
        f"({mem['cache_host_bytes']} bytes on the host); transfers "
        f"{engine.transfer_stats.snapshot()}")
    if not len(ids) or len(ids) != len(store) \
            or mem["cache_host_bytes"] != len(store) * store.row_bytes \
            or not np.isfinite(block).all() \
            or not np.abs(block).max(axis=1).all():
        raise RuntimeError(f"cohort 1M: safa left {len(store)} rows "
                           f"({len(ids)} stamped), host bytes "
                           f"{mem['cache_host_bytes']}")
    if engine.transfer_stats.sync_copies:
        raise RuntimeError("cohort 1M: a synchronous copy")


# the spans every profile of an FL loop must show (repro_torch.obs span
# names); an offload engine adds the stream's two calls a round
PROFILE_SPANS_HOST = ("plan", "trainer", "server_step", "observe",
                      "eval_readback")
PROFILE_SPANS_DEVICE = ("dynamics_step", "plan", "trainer", "round_cut",
                        "server_step", "observe", "eval", "ledger_resolve")


def phase_profile(engine, policy, tag, rounds=3, top=12):
    """Where a round's time goes: a ``Telemetry`` session with no metrics
    (``level=None``) over a short run after the timed one — the port's
    tracer spans every seam of the round (``repro_torch.obs`` span names)
    and its ``torch.profiler`` window records them as ranges.  Prints
    the rounds' wall clock (the tracer), host time (the tracer) and
    kernel time (the profiler) per span, the device's busy share of the
    wall clock and the operators with the most device time."""
    from torch.autograd import DeviceType
    from repro_torch.fleet import get_dynamics
    from repro_torch.obs import Telemetry

    tel = Telemetry(level=None, profile_rounds=(0, rounds))
    engine.run(policy, rounds=rounds, diagnostics=False, telemetry=tel)
    # the wall clock of the rounds from the tracer: from round 0's first
    # span (the profiler window opens just before it) to the end of the
    # ``rounds`` span (the loop's last read-back; the window closes after
    # it), so neither the profiler's start nor its stop is counted
    starts = [ts for _, ts, dur, args in tel.tracer.events
              if dur is not None and args and args.get("round") == 0]
    loop = [ts + dur for name, ts, dur, _ in tel.tracer.events
            if name == "rounds"]
    wall_ms = (loop[-1] - min(starts)) / 1e3 / rounds
    host_spans = tel.tracer.summary()
    want = PROFILE_SPANS_HOST \
        if get_dynamics(engine.fl_cfg.dynamics).host_side \
        else PROFILE_SPANS_DEVICE
    if getattr(engine, "_cache_stream", None) is not None:
        want += ("cache_fetch", "cache_stage")
    for span in want:
        if span not in host_spans:
            raise RuntimeError(f"{tag}: no {span!r} span recorded")
    events = tel.last_profile.key_averages()
    host = {e.key: e for e in events if e.device_type == DeviceType.CPU}
    # CUDA-side events are the kernels plus one annotation per span (the
    # span's extent on the device timeline), kept out of the sum
    device = {e.key: e for e in events if e.device_type == DeviceType.CUDA}
    busy_ms = sum(e.self_device_time_total for k, e in device.items()
                  if k not in host_spans) / 1e3 / rounds
    log(f"[{tag}] {rounds} rounds at N={engine.fl_cfg.num_clients}: wall "
        f"{wall_ms:.2f} ms/round, device busy {busy_ms:.2f} ms/round "
        f"(idle {1 - busy_ms / wall_ms:.1%})")
    for span, s in sorted(host_spans.items(), key=lambda kv: -kv[1][
            "total_s"]):
        if span == "rounds":
            continue
        kern = host[span].device_time_total / 1e3 / rounds \
            if span in host else 0.0
        log(f"[{tag}]   span {span:15s} x{s['count'] // rounds:<2d} host "
            f"{s['total_s'] * 1e3 / rounds:7.2f} ms/round, kernels "
            f"{kern:7.2f} ms/round")
    ops = [e for e in host.values() if e.key not in host_spans
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


def rel_gap(got, want):
    """(max |got - want|, max |got - want| / max(1, |want|), first greedy
    token equal) of two logit tensors."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return (float(err.max()), float((err / want.abs().clamp_min(1.0)).max()),
            bool(torch.equal(got.argmax(-1), want.argmax(-1))))


def compare_prefill(tag, dtype, per_prefill, got, want):
    """Log the last-position logits of a prefill through the kernels
    against the plain path's; returns (max error / max(1, |logit|),
    first greedy token equal)."""
    want = want.float()
    err, rel, same = rel_gap(got, want)
    top2 = want.topk(2, dim=-1).values
    log(f"[{tag}] {dtype} prefill logits, kernels ({', '.join(per_prefill)})"
        f" against the plain attention and scans: max abs err "
        f"{err:.4e}, max err / max(1, |logit|) {rel:.4e}; first"
        f" greedy token equal {same} (top-2 logit gaps "
        f"{[round(float(g), 4) for g in top2[:, 0] - top2[:, 1]]})")
    return rel, same


def phase_serve(label, arch, B, S, N, n_params, per_prefill, gate,
                counters):
    """``serve()`` at full width and depth, bf16, random weights from a
    seed: a warm-up, then the timed run with every kernel count set to 0
    just before it and read just after (``per_prefill`` launches of each
    kernel of the path, none in a decode step); the same prefill under
    the plain attention and scans, held to SERVE_BF16_TOL and the same
    first token where ``gate`` is "bf16", and logged where it is "fp32":
    then the kernel and plain prefills are rerun on fp32 copies of the
    weights and held to SERVE_F32_FULL_TOL and the same first token, and
    the timed bf16 prefill is held to the fp32 plain one at
    SERVE_BF16_RATIO times the bf16 plain prefill's gap to it; a
    profiled prefill + 4 decode steps.  Returns the launches of the timed
    run."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.tree import tree_map
    tag = f"serve {arch}"
    cfg = get_config(arch)
    model = build_model(cfg)
    if model.param_count() != n_params:
        raise RuntimeError(f"{tag}: {model.param_count()} parameters, "
                           f"expected {n_params}")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    log(f"[{tag}] {arch}: {model.param_count():,} parameters "
        f"({cfg.param_dtype}), drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; batch {B}, prompt {S}, "
        f"{N} greedy decode steps, window {cfg.sliding_window}")
    serve(model, params, tokens[:, :256], 2, device="cuda")   # warm-up
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    res = serve(model, params, tokens, N, device="cuda")
    launches = {name: c.count for name, c in counters.items()}
    variants = {name: dict(c.by_variant) for name, c in counters.items()
                if c.by_variant}
    VARIANT_LAUNCHES[label] = variants
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] prefill {res.prefill_s * 1e3:.1f} ms "
        f"({B * S / res.prefill_s:.0f} tok/s); decode "
        f"{res.decode_s * 1e3 / N:.2f} ms/step "
        f"({B * N / res.decode_s:.0f} tok/s); peak device memory "
        f"{peak:.2f} GiB; launches {launches}")
    log(f"[{tag}] ids (first request) {res.ids[0].tolist()}")
    want = {name: per_prefill.get(name, 0) for name in counters}
    if launches != want:          # one prefill, nothing in a decode step
        raise RuntimeError(f"{tag}: launches {launches}, expected {want}")
    # a bf16 prefill goes to the bf16 tensor-core variants, never SIMT
    want = {name: {v: per_prefill.get(name, 0) if v in ("wgmma", "mma")
                   else 0 for v in by_variant}
            for name, by_variant in variants.items()}
    log(f"[{tag}] launches by variant {variants}")
    if variants != want:
        raise RuntimeError(f"{tag}: launches by variant {variants}, "
                           f"expected {want}")
    if res.ids.shape != (B, N + 1) or not bool(
            ((res.ids >= 0) & (res.ids < cfg.vocab_size)).all()) \
            or not bool(torch.isfinite(res.logits).all()):
        raise RuntimeError(f"{tag}: ids {tuple(res.ids.shape)} out of "
                           f"range or non-finite logits")

    plain_cfg = ExecConfig(attn_impl="torch")
    with torch.inference_mode():
        plain, _ = model.prefill(params, {"tokens": tokens}, plain_cfg,
                                 max_len=S + N + 1)
    rel, same = compare_prefill(f"{tag}", cfg.compute_dtype, per_prefill,
                                res.logits[:, 0], plain[:, -1])
    if gate == "bf16" and (rel > SERVE_BF16_TOL or not same):
        raise RuntimeError(f"{tag}: prefill logits differ by {rel:.4f} of "
                           f"max(1, |logit|) from the plain path, or the "
                           f"first greedy token differs")
    if gate == "fp32":
        # the recurrences carry bf16 rounding through every layer: the
        # kernels are held to the plain path in fp32 at full width
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        model32 = build_model(cfg32)
        p32 = tree_map(lambda t: t.float(), params)
        before = {name: dict(c.by_variant) for name, c in counters.items()
                  if c.by_variant}
        with torch.inference_mode():
            kern, _ = model32.prefill(p32, {"tokens": tokens}, ExecConfig(),
                                      max_len=S + 1)
            plain32, _ = model32.prefill(p32, {"tokens": tokens},
                                         plain_cfg, max_len=S + 1)
        ran = {name: {v: n - before[name][v] for v, n in
                      counters[name].by_variant.items()}
               for name in before}
        log(f"[{tag}] fp32 prefill launches by variant {ran}")
        if "ssm_scan" in per_prefill and ran["ssm_scan"] != {
                "mma_f32": per_prefill["ssm_scan"], "mma": 0, "simt": 0}:
            raise RuntimeError(f"{tag}: the fp32 prefill's ssm_scan "
                               f"launches {ran['ssm_scan']}, expected "
                               f"{per_prefill['ssm_scan']} mma_f32")
        rel, same = compare_prefill(f"{tag}", "float32", per_prefill,
                                    kern[:, -1], plain32[:, -1])
        del p32, kern
        if rel > SERVE_F32_FULL_TOL or not same:
            raise RuntimeError(f"{tag}: fp32 prefill logits differ by "
                               f"{rel:.3e} of max(1, |logit|) from the "
                               f"plain path, or the first greedy token "
                               f"differs")
        # the timed bf16 path, against the fp32 plain prefill, beside the
        # bf16 plain path's own distance to it
        want32 = plain32[:, -1]
        _, gap_k, tok_k = rel_gap(res.logits[:, 0], want32)
        _, gap_p, tok_p = rel_gap(plain[:, -1], want32)
        log(f"[{tag}] bfloat16 prefill logits against the float32 plain "
            f"path, max err / max(1, |logit|): kernels {gap_k:.4e} (first "
            f"token equal {tok_k}), plain {gap_p:.4e} (first token equal "
            f"{tok_p}); ratio {gap_k / max(gap_p, 1e-30):.3f}, held to "
            f"{SERVE_BF16_RATIO}")
        del plain32
        if not gap_k <= SERVE_BF16_RATIO * gap_p:
            raise RuntimeError(f"{tag}: the bf16 kernel path is {gap_k:.4e}"
                               f" of max(1, |logit|) from the fp32 plain "
                               f"path, more than {SERVE_BF16_RATIO} times "
                               f"the bf16 plain path's {gap_p:.4e}")
    del plain, res
    profile_serve(tag, model, params, tokens)
    del params
    torch.cuda.empty_cache()
    return launches


# launches by variant of each kernel that has variants (flash_attention,
# ssm_scan, rwkv6_scan), in each timed serve run
VARIANT_LAUNCHES = {}
# the device-side names of the port's serve kernels (launched through
# ctypes, outside any aten op)
KERNEL_NAMES = ("flash_fwd", "ssd_fwd", "wkv_fwd")


def profile_serve(tag, model, params, tokens, steps=4, top=12):
    """``torch.profiler`` over one prefill and ``steps`` decode steps,
    ``serve()`` spanning ``prefill`` and each ``decode_step`` with the
    port's tracer: wall, device busy and idle share, the hand-written
    kernels' share of the device time, and the operators with the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serve
    from repro_torch.obs import Tracer

    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(model, params, tokens, steps, device="cuda", tracer=tracer)
        wall_ms = (time.perf_counter() - t0) * 1e3
    host_spans = tracer.summary()
    # neither the spans' device-side extents nor the profiler's marker for
    # a full launch queue (the host running ahead) is an operator
    spans = ("prefill", "decode_step", "Command Buffer Full")
    events = prof.key_averages()
    host = {e.key: e for e in events if e.device_type == DeviceType.CPU}
    device = {e.key: e for e in events if e.device_type == DeviceType.CUDA}
    busy_ms = sum(e.self_device_time_total for k, e in device.items()
                  if k not in spans) / 1e3
    mine = {k: e for k, e in device.items()
            if any(n in k for n in KERNEL_NAMES)}
    kern_ms = sum(e.self_device_time_total for e in mine.values()) / 1e3
    log(f"[{tag} profile] one prefill + {steps} decode steps: wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms (idle "
        f"{1 - busy_ms / wall_ms:.1%}), hand-written kernels "
        f"{kern_ms:.1f} ms ({kern_ms / busy_ms:.1%} of device time)")
    # the kernels are launched through ctypes, outside any aten op: the
    # profiler does not count them in the prefill span's kernels
    for span in spans[:2]:
        if span not in host or span not in host_spans:
            raise RuntimeError(f"{tag} profile: no {span!r} span")
        e, s = host[span], host_spans[span]
        log(f"[{tag} profile]   span {span:12s} x{s['count']:<3d} host "
            f"{s['total_s'] * 1e3:8.2f} ms, aten kernels "
            f"{e.device_time_total / 1e3:8.2f} ms"
            + (f" (+ hand-written kernels {kern_ms:.2f} ms)"
               if span == "prefill" else ""))
    ops = [e for e in host.values() if e.key not in spans
           and e.self_device_time_total > 0]
    ops += list(mine.values())
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        log(f"[{tag} profile]   {ms:8.3f} ms {ms / busy_ms:6.1%} "
            f"x{e.count:<5d} {e.key[:70]}")


def phase_serve_card_vs_cpu():
    """The reduced configs in fp32 on both devices from the same
    parameters and prompt: logits within SERVE_F32_TOL of max(1,
    |logit|), ids equal; the card's flash launches all ``wgmma_f32``
    (one a prefill's attention layer or shared-attention application),
    none ``simt``, and zamba2's ssm_scan launches all ``mma_f32``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    # the stateful families at a prompt past RWKV's S > 64 switch and
    # ragged against zamba2-reduced's chunk of 32
    for arch, prompt in (("qwen2-7b", 32), ("h2o-danube-1.8b", 32),
                         ("zamba2-1.2b", 72), ("rwkv6-7b", 72)):
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        tokens = torch.randint(0, cfg.vocab_size, (2, prompt),
                               generator=torch.Generator().manual_seed(1))
        cpu = serve(model, params, tokens, 20, device="cpu")
        before = dict(FK.launches_by_variant)
        ssd_before = dict(SK.launches.by_variant)
        card = serve(model, tree_map(lambda t: t.to("cuda"), params),
                     tokens, 20, device="cuda")
        ran = {v: n - before[v] for v, n in FK.launches_by_variant.items()}
        ssd = {v: n - ssd_before[v] for v, n in SK.launches.by_variant.items()}
        log(f"[serve card vs CPU] {cfg.name}: flash launches by variant "
            f"{ran}, ssm_scan {ssd}")
        if ssd["simt"] or ssd["mma"] or (arch == "zamba2-1.2b"
                                         and not ssd["mma_f32"]):
            raise RuntimeError(f"serve card vs CPU {cfg.name}: ssm_scan "
                               f"launches {ssd}, expected mma_f32 only")
        if ran["simt"] or ran["wgmma"] or (arch != "rwkv6-7b"
                                           and not ran["wgmma_f32"]):
            raise RuntimeError(f"serve card vs CPU {cfg.name}: flash "
                               f"launches {ran}, expected wgmma_f32 only")
        err = (card.logits.cpu() - cpu.logits).abs()
        rel = float((err / cpu.logits.abs().clamp_min(1.0)).max())
        same = bool(torch.equal(card.ids.cpu(), cpu.ids))
        log(f"[serve card vs CPU] {cfg.name} (window "
            f"{cfg.sliding_window}, prompt {prompt}, 20 steps, fp32): max "
            f"|card "
            f"- cpu| logit {float(err.max()):.3e}, of max(1, |logit|) "
            f"{rel:.3e}; ids equal {same}")
        if rel > SERVE_F32_TOL or not same:
            raise RuntimeError(f"serve card vs CPU {cfg.name}: logits "
                               f"differ by {rel:.3e} or ids differ")


def flash_bwd_bounds(B, Hq, Hkv, S, D, window, dtype=torch.float32,
                     reads_out=False, rate=None):
    """(bytes, flops, bytes ms, ops ms) of one backward: q, k, v, dO and
    lse (fp32) read once, dq, dk and dv written once, in the input type
    (the wgmma kernels, bf16 and fp32 alike, read no o); ``reads_out``
    adds the read of o (the SIMT kernels' delta = dO . o); the five
    products (S and dP recomputed, dV, dK, dQ) over the visible pairs,
    10·pairs·D flops, at ``rate`` (default the input type's: fp32's 67
    TFLOP/s, bf16 tensor cores' 989)."""
    esize = 2 if dtype == torch.bfloat16 else 4
    nbytes = esize * ((3 + reads_out) * B * Hq * S * D + 4 * B * Hkv * S * D) \
        + 4 * B * Hq * S
    flops = 10 * B * Hq * D * visible_pairs(S, S, 0, True, window)
    if rate is None:
        rate = H100_BF16_FLOPS if dtype == torch.bfloat16 \
            else H100_FP32_FLOPS
    return (nbytes, flops, nbytes / H100_BYTES_PER_S * 1e3,
            flops / rate * 1e3)


def time_flash_bwd(tag, label, B, Hq, Hkv, S, D, window, dtype, other=None):
    """The backward kernel at one training shape (causal), timed in turns
    with SDPA's backward of the same dtype (library, kernel, kernel,
    library; with ``other``, a variant of the kernel asked for by name,
    library, kernel, other, kernel, other, library), beside the plain
    backward and the bound; the kernels-line numbers (and ``other``'s
    time as ``<other>_ms``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    q, k, v = _flash_inputs(B, Hq, Hkv, S, S, D, dtype, seed=2)
    dout = torch.randn(q.shape, device="cuda").to(dtype)
    kw = dict(causal=True, window=window)
    out, lse = FK.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    if window is None:
        what = "sdpa(is_causal, enable_gqa)"
        ref_out = F.scaled_dot_product_attention(
            *leaves, is_causal=True, enable_gqa=True)
    else:
        what = "sdpa(boolean window mask, enable_gqa)"
        pos = torch.arange(S, device="cuda")
        mask = (pos[None] <= pos[:, None]) & \
            (pos[None] > pos[:, None] - window)
        ref_out = F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, enable_gqa=True)

    def library():
        return torch.autograd.grad(ref_out, leaves, dout, retain_graph=True)

    def kernel():
        return FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)

    def variant():
        return FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                           variant=other, **kw)

    reps = 20 if S <= 128 else 5
    lib = [cuda_ms(library, reps=reps, warmup=2)]
    kern, alt = [], []
    for _ in range(2):
        kern.append(cuda_ms(kernel, reps=reps, warmup=2))
        if other is not None:
            alt.append(cuda_ms(variant, reps=reps, warmup=2))
    lib.append(cuda_ms(library, reps=reps, warmup=2))
    ms, library_ms = sum(kern) / 2, sum(lib) / 2
    plain_ms = cuda_ms(lambda: attention_bwd_ref(q, k, v, dout, **kw),
                       reps=3, warmup=1)
    f32 = dtype == torch.float32
    # fp32: the kernel's bound is the tensor-core floor of fp32-accurate
    # work (six bf16 term products at 989 TFLOP/s, 165 TFLOP/s in all);
    # the 67 TFLOP/s fp32 bound is kept beside it to read against the
    # SIMT rows, and a tensor-core kernel's share of it can pass 100%
    nbytes, flops, bytes_ms, ops_ms = flash_bwd_bounds(
        B, Hq, Hkv, S, D, window, dtype,
        rate=H100_F32_TC_FLOPS if f32 else None)
    bound_ms = max(bytes_ms, ops_ms)
    rate = "989 / 6 = 165 TFLOP/s of fp32-accurate tensor-core products" \
        if f32 else "989 TFLOP/s bf16"
    if f32:
        fp32_ms = max(bytes_ms, flops / H100_FP32_FLOPS * 1e3)
        log(f"[{tag}] {label} fp32 bound {fp32_ms * 1e3:.1f} us ({flops:.4e} "
            f"flops at 67 TFLOP/s fp32, no o read): kernel at "
            f"{fp32_ms / ms:.1%} of it (can pass 100% on the tensor cores)")
    log(f"[{tag}] {label} timing (B{B} Hq{Hq}/{Hkv} S{S} D{D} window "
        f"{window}): kernel {ms:.4f} ms ({kern[0]:.4f} / {kern[1]:.4f}), "
        f"plain {plain_ms:.3f} ms, {what} {str(dtype)[6:]} backward "
        f"{library_ms:.4f} ms ({lib[0]:.4f} / {lib[1]:.4f}); bound "
        f"{bound_ms * 1e3:.1f} us ({flops:.4e} flops at {rate} take "
        f"{ops_ms * 1e3:.1f} us; {nbytes} bytes take {bytes_ms * 1e3:.1f} us "
        f"at 3.35 TB/s); kernel at {bound_ms / ms:.1%} of the bound "
        f"({flops / ms / 1e9:.2f} TFLOP/s of the counted work), sdpa at "
        f"{bound_ms / library_ms:.1%}; kernel / sdpa {ms / library_ms:.3f}")
    timing = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms,
                  bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    if f32:
        timing["fp32_bound_ms"] = fp32_ms
    if other is not None:
        alt_ms = sum(alt) / 2
        # the SIMT kernels read o: their bound at 67 TFLOP/s with it
        _, _, alt_bytes, alt_ops = flash_bwd_bounds(
            B, Hq, Hkv, S, D, window, dtype, reads_out=True)
        alt_bound = max(alt_bytes, alt_ops)
        log(f"[{tag}] {label} timing, in the same turns: {other} "
            f"{alt_ms:.4f} ms ({alt[0]:.4f} / {alt[1]:.4f}), at "
            f"{alt_bound / alt_ms:.1%} of its own bound ("
            f"{alt_bound * 1e3:.1f} us at {str(dtype)[6:]}'s rate, o read); "
            f"kernel / {other} {ms / alt_ms:.3f}")
        timing[f"{other}_ms"] = alt_ms
    return timing


def phase_flash_fwd_fp32():
    """The fp32 flash forward with its log-sum-exp (the forward fp32
    training runs under grad, twice a layer a step under remat) at the
    fp32 training shapes (FLASH_BWD_SHAPES without the window): the
    default variant (``wgmma_f32``: the split pre-pass and
    ``flash_fwd_f32``) timed in turns with SDPA's fp32 forward and with
    ``flash_fwd_simt`` by name (library, kernel, simt, kernel, simt,
    library), beside the plain attention and the bound: the larger of the
    bytes (q, k, v read and out and lse written once) at 3.35 TB/s and
    QK^T and P.V over the visible pairs at the tensor-core floor of
    fp32-accurate products (989 / 6 TFLOP/s); the 67 TFLOP/s fp32 bound
    beside it as ``fp32_bound_ms``, which SIMT reads against.  Returns
    {label: timing}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    timings = {}
    for label, B, Hq, Hkv, S, D, window in FLASH_BWD_SHAPES:
        if window is not None:
            continue
        q, k, v = _flash_inputs(B, Hq, Hkv, S, S, D, torch.float32, seed=4)

        def kernel():
            return FK.flash_attention_cuda(q, k, v, causal=True,
                                           with_lse=True)

        def simt():
            return FK.flash_attention_cuda(q, k, v, causal=True,
                                           with_lse=True, variant="simt")

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        reps = 20 if S <= 128 else 5
        lib = [cuda_ms(library, reps=reps, warmup=2)]
        kern, alt = [], []
        for _ in range(2):
            kern.append(cuda_ms(kernel, reps=reps, warmup=2))
            alt.append(cuda_ms(simt, reps=reps, warmup=2))
        lib.append(cuda_ms(library, reps=reps, warmup=2))
        ms, library_ms = sum(kern) / 2, sum(lib) / 2
        simt_ms = sum(alt) / 2
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True),
                           reps=3, warmup=1)
        nbytes = 4 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D + B * Hq * S)
        flops = 4 * B * Hq * D * visible_pairs(S, S, 0, True, None)
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = flops / H100_F32_TC_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        fp32_ms = max(bytes_ms, flops / H100_FP32_FLOPS * 1e3)
        log(f"[flash_fwd fp32] {label} (B{B} Hq{Hq}/{Hkv} S{S} D{D}, causal, "
            f"with lse): kernel (wgmma_f32) {ms:.4f} ms ({kern[0]:.4f} / "
            f"{kern[1]:.4f}), simt {simt_ms:.4f} ms ({alt[0]:.4f} / "
            f"{alt[1]:.4f}), plain {plain_ms:.3f} ms, sdpa(is_causal, "
            f"enable_gqa) fp32 forward {library_ms:.4f} ms ({lib[0]:.4f} / "
            f"{lib[1]:.4f}); bound {bound_ms * 1e3:.1f} us ({flops:.4e} "
            f"flops take {ops_ms * 1e3:.1f} us at 989 / 6 = 165 TFLOP/s of "
            f"fp32-accurate tensor-core products; {nbytes} bytes take "
            f"{bytes_ms * 1e3:.1f} us at 3.35 TB/s); kernel at "
            f"{bound_ms / ms:.1%} of the bound, sdpa at "
            f"{bound_ms / library_ms:.1%}; kernel / simt "
            f"{ms / simt_ms:.3f}, kernel / sdpa {ms / library_ms:.3f}; the "
            f"fp32 bound (67 TFLOP/s) {fp32_ms * 1e3:.1f} us: kernel at "
            f"{fp32_ms / ms:.1%}, simt at {fp32_ms / simt_ms:.1%}")
        timings[label] = dict(ms=ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound_ms,
                              bound_by="bytes" if bytes_ms >= ops_ms
                              else "operations", fp32_bound_ms=fp32_ms,
                              simt_ms=simt_ms)
        del q, k, v
        torch.cuda.empty_cache()
    return timings


def ssd_fwd_bounds(B, S, H, P, N, G, with_h0=False, split=True):
    """(bytes, flops, bytes ms, ops ms) of one fp32 ssm_scan forward: x,
    dt, A, B and C (and h0 when given) read once, y and the final state
    written once, fp32; the chunked form's products at chunk 64 (the last
    chunk ragged) that such a call needs, per chunk of L rows: over the
    L(L+1)/2 pairs l <= i, C.B^T and M'.x, N + P multiply-adds a pair;
    the L x P x N state update on every chunk (the final state is an
    output) and C.state^T on every chunk but the first without h0 (the
    state is zero there).  2 flops a multiply-add; with ``split``
    (``ssd_fwd_mma_f32``) the flops of its bf16 term products, six for a
    product of two three-term factors (``ref.FWD_F32_TERMS``), at the
    tensor cores' 989 TFLOP/s; without, the products themselves at
    fp32's 67 TFLOP/s (what ``ssd_fwd_simt`` reads against)."""
    nbytes = 4 * (2 * B * S * H * P + 2 * B * S * G * N + B * S * H + H
                  + B * H * P * N * (2 if with_h0 else 1))
    macs = 0
    for c0 in range(0, S, 64):
        L = min(64, S - c0)
        macs += L * (L + 1) // 2 * (N + P) + L * P * N * (
            1 + (c0 > 0 or with_h0))
    flops = 2 * macs * B * H * (6 if split else 1)
    rate = H100_BF16_FLOPS if split else H100_FP32_FLOPS
    return (nbytes, flops, nbytes / H100_BYTES_PER_S * 1e3,
            flops / rate * 1e3)


# the fp32 SSD forward's timed shapes: (label, B, S, H): zamba2 at
# --scale 100m and 10m (8 silos x 4 x 128; heads of 64, N 64, one group)
# and one full zamba2-1.2b layer at the serve prefill's (B 4, S 4096)
SSD_FWD_SHAPES = [
    ("100m training", 32, 128, 24),
    ("10m training", 32, 128, 12),
    ("zamba2-1.2b layer", 4, 4096, 64),
]


def phase_scan_fwd_fp32():
    """The fp32 scan forwards at the training shapes that launch them
    (twice a layer a step under remat).  The SSD's default
    (``ssd_fwd_mma_f32``, through its op in the model's layout) and
    ``ssd_fwd_simt`` by name, timed in turns (kernel, simt, kernel, simt)
    at SSD_FWD_SHAPES (P = N = 64, G 1), beside the bound
    (``ssd_fwd_bounds``: the larger of the bytes at 3.35 TB/s and the
    term products at 989 TFLOP/s), the fp32 bound (the products at 67
    TFLOP/s, ``fp32_bound_ms``) and, at 100m, the plain per-step oracle;
    ``wkv_fwd_simt`` at rwkv6 100m (B 32, S 128, H 12, D 64), timed twice
    beside its plain form and its bound (the larger of its bytes and its
    per-step 5·D² operations at 67 TFLOP/s).  No single PyTorch call
    computes either.  Returns {"ssm_scan": {label: timing},
    "rwkv6_scan": timing}."""
    from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    f32 = torch.float32
    P, N, G = 64, 64, 1
    ssd = {}
    for label, B, S, H in SSD_FWD_SHAPES:
        x, dt, A, Bm, Cm, _ = _ssd_inputs(B, S, H, P, N, G, f32, seed=11)
        k = [t.transpose(1, 2) for t in (x, dt, Bm, Cm)]
        reps = 20 if S <= 128 else 5
        kern, alt = [], []
        for _ in range(2):
            kern.append(cuda_ms(lambda: ssm_scan(x, dt, A, Bm, Cm),
                                reps=reps, warmup=3))
            alt.append(cuda_ms(lambda: SK.ssm_scan_cuda(
                k[0], k[1], A, k[2], k[3], variant="simt"), reps=reps,
                warmup=3))
        plain_ms = cuda_ms(lambda: ssm_scan(x, dt, A, Bm, Cm,
                                            impl="torch"), reps=3,
                           warmup=1) if label == "100m training" else None
        nbytes, flops, bytes_ms, ops_ms = ssd_fwd_bounds(B, S, H, P, N, G)
        _, flops32, _, fp32_ops_ms = ssd_fwd_bounds(B, S, H, P, N, G,
                                                    split=False)
        ms, simt_ms = sum(kern) / 2, sum(alt) / 2
        bound_ms = max(bytes_ms, ops_ms)
        fp32_ms = max(bytes_ms, fp32_ops_ms)
        log(f"[scan_fwd fp32] ssm_scan at zamba2 {label} (B{B} S{S} H{H} "
            f"P{P} N{N} G{G}): mma_f32 {ms:.4f} ms ({kern[0]:.4f} / "
            f"{kern[1]:.4f}), simt {simt_ms:.4f} ms ({alt[0]:.4f} / "
            f"{alt[1]:.4f}) in the same turns, plain "
            + (f"{plain_ms:.3f} ms" if plain_ms else "not timed")
            + f"; bound {bound_ms * 1e3:.1f} us ({nbytes} bytes take "
            f"{bytes_ms * 1e3:.1f} us at 3.35 TB/s; {flops:.4e} flops of "
            f"bf16 term products take {ops_ms * 1e3:.1f} us at 989 "
            f"TFLOP/s): mma_f32 at {bound_ms / ms:.1%}, simt at "
            f"{bound_ms / simt_ms:.1%}; fp32 bound {fp32_ms * 1e3:.1f} us "
            f"({flops32:.4e} flops at 67 TFLOP/s): mma_f32 at "
            f"{fp32_ms / ms:.1%}, simt at {fp32_ms / simt_ms:.1%}; "
            f"mma_f32 / simt {ms / simt_ms:.3f}")
        ssd[label] = dict(at=f"zamba2 {label} (B {B}, S {S}, H {H}, P = N "
                          f"= 64, G 1, fp32)", ms=ms, plain_ms=plain_ms,
                          library_ms=None, bound_ms=bound_ms,
                          bound_by="bytes" if bytes_ms >= ops_ms
                          else "operations", fp32_bound_ms=fp32_ms,
                          simt_ms=simt_ms)
        del x, dt, A, Bm, Cm, k
        torch.cuda.empty_cache()
    B, S, H, D = 32, 128, 12, 64
    r, k, v, logw, u, _ = _wkv_inputs(B, S, H, D, f32, seed=12)
    fn, plain = wkv_kernel_adapter("cuda"), wkv_kernel_adapter("torch")
    kern = [cuda_ms(lambda: fn(r, k, v, logw, u, None), reps=20, warmup=3)
            for _ in range(2)]
    plain_ms = cuda_ms(lambda: plain(r, k, v, logw, u, None), reps=3,
                       warmup=1)
    nbytes, _, bytes_ms, _, ops_ms = wkv_bounds(B, S, H, D, f32, False)
    ms = sum(kern) / 2
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[scan_fwd fp32] rwkv6_scan at rwkv6 100m training (B 32, S 128, "
        f"H 12, D 64, fp32): kernel {ms:.4f} ms ({kern[0]:.4f} / "
        f"{kern[1]:.4f}), plain {plain_ms:.3f} ms; bound "
        f"{bound_ms * 1e3:.1f} us ({nbytes} bytes take "
        f"{bytes_ms * 1e3:.1f} us at 3.35 TB/s, the fp32 operations "
        f"{ops_ms * 1e3:.1f} us at 67 TFLOP/s); kernel at "
        f"{bound_ms / ms:.1%} of the bound")
    wkv = dict(at="rwkv6 100m training (B 32, S 128, H 12, D 64, fp32)",
               ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound_ms,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return {"ssm_scan": ssd, "rwkv6_scan": wkv}


def ssd_fwd_f64_distances():
    """y and the final state of the fp32 SSD forward from a float64 truth
    (the per-step oracle in float64 on the same fp32 values, on the card)
    at SSD_FWD_F64_CASES, each as max |x - truth| / max(1, max |truth|):
    the default (``mma_f32``, through the op), ``ssd_fwd_simt`` by name
    and the plain fp32 per-step oracle.  Logs each way and the default's
    ratio to the SIMT kernel's distance, and raises if y or the state of
    the default lies more than SSD_F64_RATIO times as far from float64
    as the SIMT kernel's.  Returns {case: {way: {output: share}}}."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    found = {}
    for label, B, S, H, P, N, G, with_h0 in SSD_FWD_F64_CASES:
        x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, S, H, P, N, G, torch.float32,
                                           seed=S + H + 7, with_h0=with_h0)
        args = [x, dt, A, Bm, Cm, h0]
        truth = ssm_scan(*[None if t is None else t.double() for t in args],
                         impl="torch")
        k = [t.transpose(1, 2) for t in (x, dt, Bm, Cm)]
        ys, hs = SK.ssm_scan_cuda(k[0], k[1], A, k[2], k[3], h0,
                                  variant="simt")
        got = {"mma_f32": ssm_scan(*args),
               "simt": (ys.transpose(1, 2), hs),
               "plain fp32": ssm_scan(*args, impl="torch")}
        torch.cuda.synchronize()
        dist = {way: {n: f64_share(o, t) for n, o, t in
                      zip(("y", "state"), outs, truth)}
                for way, outs in got.items()}
        found[label] = dist
        ratio = {n: dist["mma_f32"][n] / max(dist["simt"][n], 1e-300)
                 for n in ("y", "state")}
        worse = [n for n, r in ratio.items() if r > SSD_F64_RATIO]
        log(f"[ssm_scan] float64 truth, {label} (B{B} S{S} H{H} P{P} N{N} "
            f"G{G}, h0 {with_h0}): " + "; ".join(
                f"{way} y {d['y']:.3e}, state {d['state']:.3e}"
                for way, d in dist.items())
            + " of max(1, max |x|); mma_f32 over simt "
            + ", ".join(f"{n} {r:.3f}" for n, r in ratio.items())
            + f"; more than {SSD_F64_RATIO}x simt's: "
            + (", ".join(worse) if worse else "none"))
        if worse:
            raise RuntimeError(f"ssm_scan float64 truth, {label}: "
                               f"{', '.join(worse)} of mma_f32 more than "
                               f"{SSD_F64_RATIO}x as far from float64 as "
                               f"ssd_fwd_simt's")
        del x, dt, A, Bm, Cm, h0, args, truth, got, ys, hs, k
        torch.cuda.empty_cache()
    return found


def check_flash_bwd(label, got, want):
    """Raise unless each of dq, dk, dv is finite, within FLASH_BWD_TOL of
    max(1, max |g|) and within GRAD_ATTN_REL_TOL of its own max |g| (which
    a zero or lost gradient fails); returns the largest absolute error."""
    worst = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"flash_bwd {label}: {name} "
                               f"{tuple(g.shape)} or non-finite")
        err = float((g - w).abs().max())
        top = float(w.abs().max())
        bound = min(FLASH_BWD_TOL * max(1.0, top), GRAD_ATTN_REL_TOL * top)
        if err > bound:
            raise RuntimeError(f"flash_bwd {label}: {name} error {err:.3e} "
                               f"above {bound:.3e} (max |g| {top:.3e})")
        worst = max(worst, err)
    return worst


def f64_share(x, truth):
    """max |x - truth| over max(1, max |truth|), in float64."""
    return float((x.double() - truth).abs().max()) / max(
        1.0, float(truth.abs().max()))


def flash_f64_distances():
    """Each output of the fp32 flash path (out, lse, dq, dk, dv) from a
    float64 truth at FLASH_F64_SHAPES, as a share of max(1, max |x|), for
    the kernels (the defaults, ``wgmma_f32`` forward and backward), for
    the SIMT backward by name, for the SIMT forward by name with the
    default backward, and for the plain fp32 attention; and the default
    backward alone, fed the truth's out and lse rounded to fp32.  Logs
    which kernel output lies more than 2x as far as the plain version's
    and raises if out, lse, dq, dk or dv of the defaults does.  Returns
    {shape: {way: {output: share}}}."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                         attention_ref)
    names = ("out", "lse", "dq", "dk", "dv")
    found = {}
    for label, B, Hq, Hkv, S, D in FLASH_F64_SHAPES:
        q, k, v = _flash_inputs(B, Hq, Hkv, S, S, D, torch.float32,
                                seed=S + 7)
        gen = torch.Generator(device="cuda").manual_seed(S)
        dout = torch.randn(q.shape, generator=gen, device="cuda")
        ways = {}
        for way, f in (("float64", torch.float64),
                       ("plain fp32", torch.float32)):
            leaves = [x.detach().to(f).requires_grad_(True)
                      for x in (q, k, v)]
            o = attention_ref(*leaves)
            grads = torch.autograd.grad(o, leaves, dout.to(f))
            ways[way] = (o.detach(), attention_lse_ref(q.to(f), k.to(f)),
                         *grads)
            del leaves, o, grads
        truth = ways.pop("float64")
        o, lse = FK.flash_attention_cuda(q, k, v, with_lse=True)
        ways["kernels"] = (o, lse, *FK.flash_attention_bwd_cuda(
            q, k, v, o, lse, dout))
        ways["kernels, simt backward"] = (o, lse, *FK.flash_attention_bwd_cuda(
            q, k, v, o, lse, dout, variant="simt"))
        os_, ls_ = FK.flash_attention_cuda(q, k, v, with_lse=True,
                                           variant="simt")
        ways["simt forward, default backward"] = (
            os_, ls_, *FK.flash_attention_bwd_cuda(q, k, v, os_, ls_, dout))
        o32, lse32 = truth[0].float(), truth[1].float()
        ways["bwd kernels on the truth's out, lse"] = (
            o32, lse32, *FK.flash_attention_bwd_cuda(q, k, v, o32, lse32,
                                                     dout))
        torch.cuda.synchronize()
        dist = {way: {n: f64_share(x, t) for n, x, t in zip(names, xs, truth)}
                for way, xs in ways.items()}
        found[label] = dist
        for way, d in dist.items():
            log(f"[flash_bwd] float64 truth, {label} (B{B} Hq{Hq}/{Hkv} S{S} "
                f"D{D} causal), {way}: "
                + ", ".join(f"{n} {x:.3e}" for n, x in d.items())
                + " of max(1, max |x|)")
        worse = {n: dist["kernels"][n] / max(dist["plain fp32"][n], 1e-300)
                 for n in names if dist["kernels"][n]
                 > 2 * dist["plain fp32"][n]}
        log(f"[flash_bwd] float64 truth, {label}: kernel outputs more than "
            f"2x as far as the plain fp32 version's: "
            + (", ".join(f"{n} ({r:.2f}x)" for n, r in worse.items())
               if worse else "none") + "; the ratios "
            + ", ".join(f"{n} {dist['kernels'][n] / dist['plain fp32'][n]:.3f}"
                        for n in names))
        if worse:
            raise RuntimeError(f"flash_bwd float64 truth, {label}: "
                               f"{', '.join(worse)} of the wgmma_f32 "
                               f"forward and backward more than 2x as far "
                               f"from float64 as the plain fp32 "
                               f"attention's")
        del q, k, v, dout, ways, truth, o, lse, o32, lse32, os_, ls_
        gc.collect()
        torch.cuda.empty_cache()
    return found


def phase_flash_bwd():
    """The fp32 backward (its default variant, ``wgmma_f32``) against
    autograd through the plain version at the training shapes and at
    ragged ones (GQA, q_offset, windows, non-causal, every head dim),
    reruns bit-identical; timings at the training shapes in turns with
    SDPA's fp32 backward and the SIMT backward by name, beside the plain
    backward, the fp32 bound and the tensor-core floor; the float64
    truth.  Returns its kernels-line entry (``launches`` filled in by the
    training runs)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    f32 = torch.float32
    # (label, B, Hq, Hkv, Sq, Sk, D, q_offset, causal, window)
    cases = [(label, B, Hq, Hkv, S, S, D, 0, True, window)
             for label, B, Hq, Hkv, S, D, window in FLASH_BWD_SHAPES] + [
        ("ragged, q_offset 60, window 50, group 7", 1, 7, 1, 130, 190, 64,
         60, True, 50),
        ("ragged D 80, window 40", 2, 4, 2, 97, 97, 80, 0, True, 40),
        ("non-causal D 80", 1, 4, 2, 65, 128, 80, 0, False, None),
        ("one query, D 128", 1, 4, 4, 1, 77, 128, 76, True, None),
        ("ragged D 192, window 64, group 3", 1, 6, 2, 150, 150, 192, 0, True,
         64),
    ]
    max_err = 0.0
    for label, B, Hq, Hkv, Sq, Sk, D, off, causal, window in cases:
        q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Sk, D, f32, seed=Sq + D)
        dout = torch.randn_like(q)
        kw = dict(causal=causal, window=window, q_offset=off)
        out, lse = FK.flash_attention_cuda(q, k, v, with_lse=True, **kw)
        got = FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        again = FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        err = check_flash_bwd(label, got, attention_bwd_ref(q, k, v, dout,
                                                            **kw))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        max_err = max(max_err, err)
        log(f"[flash_bwd] {label} (B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Sk{Sk} D{D} "
            f"q_offset {off} causal {causal} window {window}): max abs err "
            f"{err:.3e}; reruns bit-identical {same}")
        if not same:
            raise RuntimeError(f"flash_bwd {label}: two launches differ")
        del q, k, v, dout, out, lse, got, again

    timings = {}
    for label, B, Hq, Hkv, S, D, window in FLASH_BWD_SHAPES:
        timings[label] = time_flash_bwd("flash_bwd", label, B, Hq, Hkv, S, D,
                                        window, f32, other="simt")
        torch.cuda.empty_cache()
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:69",
            "replaces_note": "the gradient of flash_attention_pallas; the "
            "JAX package has no backward kernel (it trains through plain "
            "JAX attention and autodiff)",
            "counted_variant": "wgmma_f32",
            "launches": None, "max_abs_err": max_err, **timings["100m"],
            "at": "100m training shape (B 32, Hq 12 / Hkv 4, S 128, D 64, "
            "causal)", "by_shape": timings,
            "float64_distances": flash_f64_distances()}


def ssd_bwd_bounds(B, S, H, P, N, G, esize=4, dt_esize=4,
                   rate=H100_FP32_FLOPS, split=False):
    """(bytes, flops, bytes ms, ops ms) of one ssm_scan backward with no
    h0 and no dh_f: x, dt, A, B, C and dy (fp32) read once, dx, ddt, dA,
    dB and dC written once, x, B, C and their gradients ``esize`` bytes an
    element, dt and ddt ``dt_esize``; the products of the chunked form at
    chunk 64 (the last chunk ragged) whose results such a call reads, per
    chunk of L rows: over the L(L+1)/2 pairs l <= t, C.B^T, dY.X^T,
    M^T.dY, Q^T.C and Q.(dt B), 3N + 2P multiply-adds a pair; and the L x
    P x N products B.Gc^T and X.Gc and the forward walk's state update on
    every chunk but the last (Gc = dh_f = 0 there, and the final state is
    not read), dY.h_s and the Gc update on every chunk but the first (h_s
    = h0 = 0 there, and the update would only make dh0); 2 flops a
    multiply-add, at ``rate`` (fp32's 67 TFLOP/s; for bf16 inputs the
    tensor cores' 989).  With ``split`` (fp32 on the tensor cores, at
    989) the flops of its bf16 term products: six for a product of two
    three-term factors, five for the walk and dY.h_s, whose second factor
    has two terms (``ref.F32_TERMS``)."""
    nbytes = (esize * (2 * B * S * H * P + 4 * B * S * G * N)
              + 4 * B * S * H * P + dt_esize * 2 * B * S * H + 4 * 2 * H)
    three = two = 0    # multiply-adds with three-term / two-term factors
    n = -(-S // 64)
    for c in range(n):
        L = min(64, S - 64 * c)
        lpn = L * P * N
        three += (L * (L + 1) // 2 * (3 * N + 2 * P)
                  + lpn * (2 * (c < n - 1) + (c > 0)))
        two += lpn * ((c < n - 1) + (c > 0))
    flops = 2 * (6 * three + 5 * two if split else three + two) * B * H
    return (nbytes, flops, nbytes / H100_BYTES_PER_S * 1e3,
            flops / rate * 1e3)


def wkv_bwd_bounds(B, S, H, D):
    """(bytes, flops, bytes ms, fp32 ms) of one rwkv6_scan backward with
    no s0 and no dS_f: r, k, v, logw, dy and u read once, dr, dk, dv,
    dlogw and du written once; the per-step form's least work, 5 D^2
    multiply-adds a step and head (S.dy and the S update walking forward,
    G.v, G^T.k and the G update walking back), 2 flops each, at fp32's
    67 TFLOP/s."""
    nbytes = 4 * (9 * B * S * H * D + 2 * H * D)
    flops = 10 * D * D * B * H * S
    return (nbytes, flops, nbytes / H100_BYTES_PER_S * 1e3,
            flops / H100_FP32_FLOPS * 1e3)


def _grads(fn, leaves, dy, dlast):
    """Gradients of <fn(*leaves)[0], dy> + <fn(*leaves)[1], dlast> with
    respect to every non-None leaf (None where the leaf is)."""
    leaves = [None if t is None else t.detach().requires_grad_(True)
              for t in leaves]
    y, last = fn(*leaves)
    loss = (y * dy).sum() + ((last * dlast).sum() if dlast is not None
                             else 0.0)
    live = [t for t in leaves if t is not None]
    got = iter(torch.autograd.grad(loss, live))
    return [None if t is None else next(got) for t in leaves]


def check_scan_grads(tag, label, names, got, want, tol):
    """Raise unless each gradient is finite and within ``tol`` of max(1,
    max |g|) and within GRAD_ATTN_REL_TOL of its own max |g| (a plain
    gradient that is exactly 0 must be 0); returns the largest absolute
    error and the largest error relative to max(1, max |g|)."""
    worst_abs, worst_rel = 0.0, 0.0
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{tag} {label}: {name} {tuple(g.shape)} or "
                               f"non-finite")
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(1.0, scale))
        if err > tol * max(1.0, scale) or err > GRAD_ATTN_REL_TOL * scale:
            raise RuntimeError(f"{tag} {label}: {name} off by {err:.3e}, "
                               f"max |g| {scale:.3e} (gates {tol:.0e} of "
                               f"max(1, max |g|), {GRAD_ATTN_REL_TOL:.0e} of "
                               f"max |g|)")
    return worst_abs, worst_rel


def _time_bwd(tag, label, kernel, plain, bounds,
              rate_name="fp32's 67 TFLOP/s", other=None, fp32_bounds=None):
    """Device times of the backward kernel and of the plain autograd
    backward (``plain`` None: not timed), beside the bound (its operations
    at ``rate_name``); with ``other`` (name, call), a second variant timed
    in turns with the kernel (kernel, other, kernel, other); with
    ``fp32_bounds`` (the same work at fp32's 67 TFLOP/s, for a kernel
    bound by the tensor cores' fp32-accurate rate) that bound as
    ``fp32_bound_ms``, the one the other variant is read against; the
    kernels-line numbers (and the other's time as ``<name>_ms``)."""
    nbytes, flops, bytes_ms, fp32_ms = bounds
    bound_ms = max(bytes_ms, fp32_ms)
    kern, alt = [], []
    for _ in range(2):
        kern.append(cuda_ms(kernel, reps=10, warmup=2))
        if other is not None:
            alt.append(cuda_ms(other[1], reps=10, warmup=2))
    ms = sum(kern) / 2
    plain_ms = cuda_ms(plain, reps=1, warmup=1) if plain else None
    log(f"[{tag}] {label} timing: kernel {ms:.4f} ms ({kern[0]:.4f} / "
        f"{kern[1]:.4f}), plain autograd backward "
        + (f"{plain_ms:.3f} ms" if plain_ms else "not timed")
        + f", no library call; bound {bound_ms * 1e3:.1f} us ({flops:.4e} "
        f"flops take {fp32_ms * 1e3:.1f} us at {rate_name}; {nbytes} "
        f"bytes take {bytes_ms * 1e3:.1f} us at 3.35 TB/s); kernel at "
        f"{bound_ms / ms:.1%} of the bound")
    timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by="bytes" if bytes_ms >= fp32_ms else "operations")
    alt_bound = bound_ms
    if fp32_bounds is not None:
        alt_bound = max(fp32_bounds[2], fp32_bounds[3])
        timing["fp32_bound_ms"] = alt_bound
        log(f"[{tag}] {label} fp32 bound {alt_bound * 1e3:.1f} us (the same "
            f"flops at fp32's 67 TFLOP/s): kernel at {alt_bound / ms:.1%} "
            f"of it (can pass 100% on the tensor cores)")
    if other is not None:
        alt_ms = sum(alt) / 2
        log(f"[{tag}] {label} timing, in the same turns: {other[0]} "
            f"{alt_ms:.4f} ms ({alt[0]:.4f} / {alt[1]:.4f}), at "
            f"{alt_bound / alt_ms:.1%} of "
            + ("the fp32 bound" if fp32_bounds is not None else "the bound")
            + f"; kernel / {other[0]} {ms / alt_ms:.3f}")
        timing[f"{other[0]}_ms"] = alt_ms
    return timing


def ssd_f64_ways(x, dt, A, Bm, Cm, h0, dy, dhf, ways=()):
    """The SSD gradients (dx, ddt, dA, dB, dC, dh0) in the model's layout
    at fp32 inputs four ways, each held to a float64 truth (autograd
    through the per-step oracle in float64 on the same values): the
    plain fp32 autograd (``"plain fp32"``), the default kernel through
    ``SSDScanFn`` (``"mma_f32"``), ``ssd_bwd_simt`` asked for by name
    (``"simt"``), and each (name, gradients) of ``ways``.  Returns
    {way: {gradient: max |g - truth| / max(1, max |truth|)}}, dh0 only
    where h0 is given."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    args = [x, dt, A, Bm, Cm, h0]

    def plain(*a):
        return ssm_scan(*a, impl="torch")
    truth = _grads(plain, [None if t is None else t.double() for t in args],
                   dy.double(), None if dhf is None else dhf.double())
    got = {"plain fp32": _grads(plain, args, dy, dhf),
           "mma_f32": _grads(ssm_scan, args, dy, dhf)}
    k = [t.transpose(1, 2) for t in (x, dt, Bm, Cm, dy)]
    simt = SK.ssm_scan_bwd_cuda(k[0], k[1], A, k[2], k[3], h0, k[4], dhf,
                                variant="simt")
    got["simt"] = [t.transpose(1, 2) if i in (0, 1, 3, 4) else t
                   for i, t in enumerate(simt)]
    got.update(ways)
    torch.cuda.synchronize()
    return {way: {n: f64_share(g, t) for n, g, t in zip(names, gs, truth)
                  if t is not None}
            for way, gs in got.items()}


def ssd_f64_distances():
    """Each gradient of the fp32 SSD backward from a float64 truth
    (``ssd_f64_ways``) at SSD_F64_CASES: the default (``mma_f32``), the
    SIMT kernel by name and the plain fp32 autograd.  Logs each way and
    the default's ratio to the SIMT kernel's distance, and raises if any
    gradient of the default lies more than SSD_F64_RATIO times as far
    from float64 as the SIMT kernel's.  Returns {case: {way: {gradient:
    share}}}."""
    found = {}
    for label, B, S, H, P, N, G, with_h0, with_dhf in SSD_F64_CASES:
        x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, S, H, P, N, G, torch.float32,
                                           seed=S + H + 5, with_h0=with_h0)
        gen = torch.Generator(device="cuda").manual_seed(S + 5)
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        dhf = torch.randn((B, H, P, N), generator=gen, device="cuda") \
            if with_dhf else None
        dist = ssd_f64_ways(x, dt, A, Bm, Cm, h0, dy, dhf)
        found[label] = dist
        for way, d in dist.items():
            log(f"[ssm_scan_bwd] float64 truth, {label} (B{B} S{S} H{H} P{P} "
                f"N{N} G{G}, h0 {with_h0}, dh_f {with_dhf}), {way}: "
                + ", ".join(f"{n} {v:.3e}" for n, v in d.items())
                + " of max(1, max |g|)")
        ratio = {n: dist["mma_f32"][n] / max(dist["simt"][n], 1e-300)
                 for n in dist["mma_f32"]}
        worse = [n for n, r in ratio.items() if r > SSD_F64_RATIO]
        log(f"[ssm_scan_bwd] float64 truth, {label}: mma_f32 over simt "
            + ", ".join(f"{n} {r:.3f}" for n, r in ratio.items())
            + "; over plain fp32 " + ", ".join(
                f"{n} {dist['mma_f32'][n] / max(dist['plain fp32'][n], 1e-300):.3f}"
                for n in ratio)
            + f"; more than {SSD_F64_RATIO}x simt's: "
            + (", ".join(worse) if worse else "none"))
        if worse:
            raise RuntimeError(f"ssm_scan_bwd float64 truth, {label}: "
                               f"{', '.join(worse)} of mma_f32 more than "
                               f"{SSD_F64_RATIO}x as far from float64 as "
                               f"ssd_bwd_simt's")
        del x, dt, A, Bm, Cm, h0, dy, dhf
        torch.cuda.empty_cache()
    return found


def phase_ssm_scan_bwd():
    """The fp32 SSD backward: its default kernel (``ssd_bwd_mma_f32``,
    variant ``mma_f32``, through ``SSDScanFn`` under autograd in the
    model's layout) and ``ssd_bwd_simt`` asked for by name, each against
    autograd through the per-step oracle at SSD_BWD_CASES, reruns of the
    default bit-identical; the two timed in turns at the 10m and 100m
    training shapes and at zamba2's full layer, beside the tensor-core
    bound, the fp32 bound and (at 100m) the plain autograd backward; the
    float64 truth (``ssd_f64_distances``).  Returns its kernels-line
    entry (``launches`` filled in by the training runs)."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    max_err, simt_worst, timings = 0.0, 0.0, {}
    for label, B, S, H, P, N, G, with_h0, with_dhf in SSD_BWD_CASES:
        x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, S, H, P, N, G, torch.float32,
                                           seed=S + H, with_h0=with_h0)
        gen = torch.Generator(device="cuda").manual_seed(S)
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        dhf = torch.randn((B, H, P, N), generator=gen, device="cuda") \
            if with_dhf else None
        args = [x, dt, A, Bm, Cm, h0]
        before = dict(SK.bwd_launches.by_variant)
        got = _grads(ssm_scan, args, dy, dhf)
        again = _grads(ssm_scan, args, dy, dhf)
        xk, dtk = x.transpose(1, 2), dt.transpose(1, 2)
        Bk, Ck, dyk = Bm.transpose(1, 2), Cm.transpose(1, 2), \
            dy.transpose(1, 2)
        simt = SK.ssm_scan_bwd_cuda(xk, dtk, A, Bk, Ck, h0, dyk, dhf,
                                    variant="simt")
        simt = [t.transpose(1, 2) if i in (0, 1, 3, 4) else t
                for i, t in enumerate(simt)]       # to the model's layout
        torch.cuda.synchronize()
        ran = {v: n - before[v] for v, n in SK.bwd_launches.by_variant.items()}
        if ran != {"simt": 1, "mma_bf16": 0, "simt_bf16": 0, "mma_f32": 2}:
            raise RuntimeError(f"ssm_scan_bwd {label}: launches {ran}: the "
                               f"default did not run mma_f32 once a call")
        want = _grads(lambda *a: ssm_scan(*a, impl="torch"), args, dy, dhf)
        err, rel = check_scan_grads("ssm_scan_bwd", label, names, got, want,
                                    SSM_BWD_TOL)
        s_err, s_rel = check_scan_grads("ssm_scan_bwd simt", label, names,
                                        simt, want, SSM_BWD_TOL)
        same = all(g is None or torch.equal(g, a) for g, a in zip(got, again))
        max_err, simt_worst = max(max_err, err), max(simt_worst, s_err)
        log(f"[ssm_scan_bwd] {label} (B{B} S{S} H{H} P{P} N{N} G{G}, h0 "
            f"{with_h0}, dh_f {with_dhf}): max abs err, mma_f32 {err:.3e} "
            f"({rel:.3e} of max(1, max |g|)), simt {s_err:.3e} "
            f"({s_rel:.3e}); reruns bit-identical {same}")
        if not same:
            raise RuntimeError(f"ssm_scan_bwd {label}: two launches differ")
        del got, again, want, simt
        if label in ("10m training", "100m training", "zamba2-1.2b layer"):
            plain = None
            if label == "100m training":
                leaves = [t.detach().requires_grad_(True) for t in args[:5]]
                y_plain = ssm_scan(*leaves, impl="torch")[0]

                def plain():
                    return torch.autograd.grad(y_plain, leaves, dy,
                                               retain_graph=True)
            # the bound: the tensor-core floor of the fp32-accurate
            # products (their bf16 term products at 989 TFLOP/s), or the
            # bytes
            timings[label] = _time_bwd(
                "ssm_scan_bwd", label,
                lambda: SK.ssm_scan_bwd_cuda(xk, dtk, A, Bk, Ck, None, dyk),
                plain, ssd_bwd_bounds(B, S, H, P, N, G,
                                      rate=H100_BF16_FLOPS, split=True),
                rate_name="989 TFLOP/s of bf16 term products (six for "
                "an fp32-accurate product, five where a factor has two "
                "terms)",
                other=("simt", lambda: SK.ssm_scan_bwd_cuda(
                    xk, dtk, A, Bk, Ck, None, dyk, variant="simt")),
                fp32_bounds=ssd_bwd_bounds(B, S, H, P, N, G))
            del plain
        del x, dt, A, Bm, Cm, h0, dy, dhf, args, xk, dtk, Bk, Ck, dyk
        torch.cuda.empty_cache()
    return {"name": "ssm_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/ssm_scan_bwd_mma.cu",
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:66",
            "replaces_note": "the gradient of ssm_scan_pallas on fp32 x, B "
            "and C (ssd_bwd_mma_f32: the chunk products on mma.sync with "
            "every factor as bf16 terms, three for x, B, C, dY, M, Q, Gc "
            "and e o dY, two for h_s and the forward walk's B o w o dt); "
            "the JAX package has no backward kernel (it trains through "
            "plain JAX and autodiff); ssd_bwd_simt (csrc/ssm_scan_bwd.cu) "
            "by name as the yardstick",
            "counted_variant": "mma_f32",
            "launches": None, "max_abs_err": max_err,
            "simt_max_abs_err": simt_worst,
            **timings["100m training"], "library_ms": None,
            "at": "zamba2 100m training shape (B 32, S 128, H 24, P 64, "
            "N 64, G 1)", "by_shape": timings,
            "float64_distances": ssd_f64_distances()}


def phase_rwkv6_scan_bwd():
    """The WKV backward kernel (``wkv_bwd_simt``, through ``WKV6ScanFn``
    under autograd via the model's kernel hook) against autograd through
    the per-step oracle at WKV_BWD_CASES, reruns bit-identical; timed as
    ``phase_ssm_scan_bwd`` times the SSD's."""
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter
    kern, plain_fn = wkv_kernel_adapter("cuda"), wkv_kernel_adapter("torch")
    names = ("dr", "dk", "dv", "dlogw", "du", "ds0")
    max_err, timings = 0.0, {}
    for label, B, S, H, D, with_s0, with_dsf in WKV_BWD_CASES:
        args = list(_wkv_inputs(B, S, H, D, torch.float32, seed=S + H,
                                with_s0=with_s0))
        gen = torch.Generator(device="cuda").manual_seed(S)
        dy = torch.randn(args[0].shape, generator=gen, device="cuda")
        dsf = torch.randn((B, H, D, D), generator=gen, device="cuda") \
            if with_dsf else None
        before = WK.bwd_launches.count
        got = _grads(kern, args, dy, dsf)
        again = _grads(kern, args, dy, dsf)
        torch.cuda.synchronize()
        if WK.bwd_launches.count != before + 2:
            raise RuntimeError(f"rwkv6_scan_bwd {label}: the backward "
                               f"kernel did not launch once a call")
        want = _grads(plain_fn, args, dy, dsf)
        err, rel = check_scan_grads("rwkv6_scan_bwd", label, names, got,
                                    want, WKV_BWD_TOL)
        same = all(g is None or torch.equal(g, a) for g, a in zip(got, again))
        max_err = max(max_err, err)
        log(f"[rwkv6_scan_bwd] {label} (B{B} S{S} H{H} D{D}, s0 {with_s0}, "
            f"dS_f {with_dsf}): max abs err {err:.3e} ({rel:.3e} of max(1, "
            f"max |g|)); reruns bit-identical {same}")
        if not same:
            raise RuntimeError(f"rwkv6_scan_bwd {label}: two launches "
                               f"differ")
        del got, again, want
        if label in ("100m training", "rwkv6-7b layer"):
            r, k, v, lw = (t.transpose(1, 2) for t in args[:4])
            dyk = dy.transpose(1, 2)
            u = args[4]
            plain = None
            if label == "100m training":
                leaves = [t.detach().requires_grad_(True) for t in args[:5]]
                y_plain = plain_fn(*leaves, None)[0]

                def plain():
                    return torch.autograd.grad(y_plain, leaves, dy,
                                               retain_graph=True)
            timings[label] = _time_bwd(
                "rwkv6_scan_bwd", label,
                lambda: WK.rwkv6_scan_bwd_cuda(r, k, v, lw, u, None, dyk),
                plain, wkv_bwd_bounds(B, S, H, D))
            del plain
        del args, dy, dsf
        torch.cuda.empty_cache()
    return {"name": "rwkv6_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/rwkv6_scan_bwd.cu",
            "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:55",
            "replaces_note": "the gradient of rwkv6_scan_pallas; the JAX "
            "package has no backward kernel (it trains through plain JAX "
            "and autodiff)",
            "launches": None, "max_abs_err": max_err,
            **timings["100m training"], "library_ms": None,
            "at": "rwkv6 100m training shape (B 32, S 128, H 12, D 64)",
            "by_shape": timings}


def check_bf16_grads(tag, label, names, got, want, dtypes, tol):
    """Raise unless each gradient is finite, of its input's dtype, and
    passes ``ref.bf16_grad_gate``: its excess beyond one bf16 ulp within
    ``tol`` of max(1, max |truth|) and within ``ref.BF16_BWD_OWN_TOL`` of
    its own max |truth|; returns the largest excess and the largest as a
    share of max(1, max |truth|)."""
    from repro_torch.kernels.flash_attention.ref import (BF16_BWD_OWN_TOL,
                                                         bf16_grad_gate)
    worst_abs, worst_rel = 0.0, 0.0
    for name, g, w, dt in zip(names, got, want, dtypes):
        if w is None:
            continue
        if g.shape != w.shape or g.dtype != dt \
                or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{tag} {label}: {name} {tuple(g.shape)} "
                               f"{g.dtype} (input {dt}) or non-finite")
        exc, scale, ok = bf16_grad_gate(g, w, tol)
        worst_abs = max(worst_abs, exc)
        worst_rel = max(worst_rel, exc / max(1.0, scale))
        if not ok:
            raise RuntimeError(f"{tag} {label}: {name} off by {exc:.3e} "
                               f"beyond one bf16 ulp, max |g| {scale:.3e} "
                               f"(gates {tol:.0e} of max(1, max |g|), "
                               f"{BF16_BWD_OWN_TOL:.0e} of max |g|)")
    return worst_abs, worst_rel


def phase_flash_bwd_bf16():
    """The bf16 backward (``flash_attention_bwd_cuda`` on bf16 inputs,
    after ``flash_fwd_wgmma`` with its lse): the tensor-core kernels
    (``flash_bwd_wgmma``, the default, what training runs) and the SIMT
    ones asked for by name (``variant="simt_bf16"``) on the same inputs,
    each against autograd through the plain attention in fp32 on the same
    bf16 values, upcast, at FLASH_BWD_BF16_SHAPES and ragged ones: each
    gradient bf16, within the per-element gates (``check_bf16_grads``),
    reruns bit-identical, and the wgmma lse within FLASH_LSE_TOL of
    flash_fwd_simt's on the values upcast; both variants timed in turns
    at FLASH_BWD_BF16_SHAPES beside SDPA's bf16 backward, the plain
    backward and the bf16 tensor-core bound.  Returns its kernels-line
    entry (``launches`` filled in by the training runs)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    bf16 = torch.bfloat16
    cases = [(label, B, Hq, Hkv, S, S, D, 0, True, window)
             for label, B, Hq, Hkv, S, D, window in FLASH_BWD_BF16_SHAPES] + [
        ("ragged, q_offset 60, window 50, group 7", 1, 7, 1, 130, 190, 64,
         60, True, 50),
        ("ragged D 32, window 40", 2, 4, 2, 97, 97, 32, 0, True, 40),
        ("non-causal D 80", 1, 4, 2, 65, 128, 80, 0, False, None),
        ("one query, D 128", 1, 4, 4, 1, 77, 128, 76, True, None),
        ("ragged D 192, window 64, group 3", 1, 6, 2, 150, 150, 192, 0, True,
         64),
        ("D 192, group 1, ragged", 2, 4, 4, 200, 200, 192, 0, True, None),
        ("D 64, group 4, B 4 (the group summed in the block)", 4, 16, 4,
         2048, 2048, 64, 0, True, None),
    ]
    max_err, lse_worst, simt_worst = 0.0, 0.0, 0.0
    for label, B, Hq, Hkv, Sq, Sk, D, off, causal, window in cases:
        q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Sk, D, bf16, seed=Sq + D + 1)
        gen = torch.Generator(device="cuda").manual_seed(Sk)
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
        kw = dict(causal=causal, window=window, q_offset=off)
        before = dict(FK.launches_by_variant)
        bwd_before = dict(FK.bwd_launches.by_variant)
        out, lse = FK.flash_attention_cuda(q, k, v, with_lse=True, **kw)
        lse32 = FK.flash_attention_cuda(q.float(), k.float(), v.float(),
                                        with_lse=True, variant="simt",
                                        **kw)[1]
        got = FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        again = FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        simt = FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                           variant="simt_bf16", **kw)
        torch.cuda.synchronize()
        if {n: c - before[n] for n, c in FK.launches_by_variant.items()} \
                != {"wgmma": 1, "wgmma_f32": 0, "simt": 1}:
            raise RuntimeError(f"flash_bwd bf16 {label}: the lse forwards "
                               f"did not run one wgmma and one SIMT launch")
        ran = {n: c - bwd_before[n]
               for n, c in FK.bwd_launches.by_variant.items()}
        if ran != {"wgmma_f32": 0, "simt": 0, "wgmma_bf16": 2,
                   "simt_bf16": 1}:
            raise RuntimeError(f"flash_bwd bf16 {label}: backward launches "
                               f"{ran}, expected two wgmma_bf16 and one "
                               f"simt_bf16")
        lse_gap = float(((lse - lse32).abs()
                         / lse32.abs().clamp_min(1.0)).max())
        want = attention_bwd_ref(q.float(), k.float(), v.float(),
                                 dout.float(), **kw)
        err, rel = check_bf16_grads("flash_bwd bf16", label,
                                    ("dq", "dk", "dv"), got, want,
                                    (bf16,) * 3, FLASH_BWD_TOL)
        s_err, s_rel = check_bf16_grads("flash_bwd bf16 simt_bf16", label,
                                        ("dq", "dk", "dv"), simt, want,
                                        (bf16,) * 3, FLASH_BWD_TOL)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        max_err, lse_worst = max(max_err, err), max(lse_worst, lse_gap)
        simt_worst = max(simt_worst, s_err)
        log(f"[flash_bwd bf16] {label} (B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Sk{Sk} "
            f"D{D} q_offset {off} causal {causal} window {window}; blocks a "
            f"query head: {FK.per_head_blocks(B, Hq, Hkv, Sk)}): largest "
            f"excess beyond one bf16 ulp, wgmma_bf16 {err:.3e} ({rel:.3e} "
            f"of max(1, max |g|)), simt_bf16 {s_err:.3e} ({s_rel:.3e}); "
            f"wgmma lse within {lse_gap:.3e} of the SIMT lse, of max(1, "
            f"|lse|) (gate {FLASH_LSE_TOL:.0e}); reruns bit-identical {same}")
        if lse_gap > FLASH_LSE_TOL or not math.isfinite(lse_gap):
            raise RuntimeError(f"flash_bwd bf16 {label}: wgmma lse off the "
                               f"SIMT lse by {lse_gap:.3e}")
        if not same:
            raise RuntimeError(f"flash_bwd bf16 {label}: two launches differ")
        del q, k, v, dout, out, lse, lse32, got, again, simt, want
        torch.cuda.empty_cache()

    timings = {}
    for label, B, Hq, Hkv, S, D, window in FLASH_BWD_BF16_SHAPES:
        timings[label] = time_flash_bwd("flash_bwd bf16", label, B, Hq, Hkv,
                                        S, D, window, bf16,
                                        other="simt_bf16")
        torch.cuda.empty_cache()
    return {"name": "flash_attention_bwd_bf16", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:69",
            "replaces_note": "the gradient of flash_attention_pallas on "
            "bf16 inputs (flash_bwd_wgmma: TMA and wgmma, P and dS as two "
            "bf16 terms, each gradient rounded once to bf16); the JAX "
            "package has no backward kernel",
            "counter": "flash_attention_bwd", "counted_variant": "wgmma_bf16",
            "launches": None, "max_abs_err": max_err,
            "simt_bf16_max_abs_err": simt_worst,
            "lse_max_gap": lse_worst, **timings["zamba2-1.2b training"],
            "at": "zamba2-1.2b training shape (B 32, Hq = Hkv = 32, S 128, "
            "D 64, causal, bf16)", "by_shape": timings}


def phase_ssm_scan_bwd_bf16():
    """The SSD backward on bf16 x, B and C after ``ssd_fwd_mma``: the
    tensor-core kernel (``ssd_bwd_mma``, variant ``mma_bf16``, the
    default, what training runs, through ``SSDScanFn`` under autograd)
    and the SIMT one asked for by name (``variant="simt_bf16"``) on the
    same inputs, each against autograd through the per-step oracle in
    fp32 on the same values upcast, at SSD_BWD_BF16_CASES: each gradient
    in its input's dtype, within the per-element gates
    (``check_bf16_grads``), reruns bit-identical; the two variants timed
    in turns at the training shape and the full layer beside the bf16
    tensor-core bound and (training shape) the plain autograd backward.
    Returns its kernels-line entry (``launches`` filled in by the
    training runs)."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    max_err, simt_worst, timings = 0.0, 0.0, {}
    for label, B, S, H, P, N, G, with_h0, with_dhf, dt_dtype in \
            SSD_BWD_BF16_CASES:
        x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, S, H, P, N, G, torch.bfloat16,
                                           seed=S + H + 1, with_h0=with_h0)
        dt = dt.to(dt_dtype)
        gen = torch.Generator(device="cuda").manual_seed(S + 1)
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        dhf = torch.randn((B, H, P, N), generator=gen, device="cuda") \
            if with_dhf else None
        args = [x, dt, A, Bm, Cm, h0]
        before = dict(SK.bwd_launches.by_variant)
        fwd_before = dict(SK.launches.by_variant)
        got = _grads(ssm_scan, args, dy, dhf)
        again = _grads(ssm_scan, args, dy, dhf)
        xk, dtk = x.transpose(1, 2), dt.transpose(1, 2)
        Bk, Ck, dyk = Bm.transpose(1, 2), Cm.transpose(1, 2), \
            dy.transpose(1, 2)
        simt = SK.ssm_scan_bwd_cuda(xk, dtk, A, Bk, Ck, h0, dyk, dhf,
                                    variant="simt_bf16")
        simt = [t.transpose(1, 2) if i in (0, 1, 3, 4) else t
                for i, t in enumerate(simt)]       # to the model's layout
        torch.cuda.synchronize()
        ran = {v: n - before[v] for v, n in SK.bwd_launches.by_variant.items()}
        fwd = {v: n - fwd_before[v] for v, n in SK.launches.by_variant.items()}
        if ran != {"simt": 0, "mma_bf16": 2, "simt_bf16": 1, "mma_f32": 0} \
                or fwd != {"mma_f32": 0, "mma": 2, "simt": 0}:
            raise RuntimeError(f"ssm_scan_bwd bf16 {label}: launches {fwd} "
                               f"forward, {ran} backward")
        want = _grads(lambda *a: ssm_scan(*a, impl="torch"),
                      [None if t is None else t.float() for t in args], dy,
                      dhf)
        dtypes = [None if t is None else t.dtype for t in args]
        err, rel = check_bf16_grads("ssm_scan_bwd bf16", label, names, got,
                                    want, dtypes, SSM_BWD_TOL)
        s_err, s_rel = check_bf16_grads("ssm_scan_bwd bf16 simt_bf16", label,
                                        names, simt, want, dtypes,
                                        SSM_BWD_TOL)
        same = all(g is None or torch.equal(g, a) for g, a in zip(got, again))
        max_err, simt_worst = max(max_err, err), max(simt_worst, s_err)
        log(f"[ssm_scan_bwd bf16] {label} (B{B} S{S} H{H} P{P} N{N} G{G}, dt "
            f"{dt_dtype}, h0 {with_h0}, dh_f {with_dhf}; heads a block "
            f"{SK.heads_per_block(B, H, G)}): largest excess beyond one bf16 "
            f"ulp, mma_bf16 {err:.3e} ({rel:.3e} of max(1, max |g|)), "
            f"simt_bf16 {s_err:.3e} ({s_rel:.3e}); reruns bit-identical "
            f"{same}")
        if not same:
            raise RuntimeError(f"ssm_scan_bwd bf16 {label}: two launches "
                               f"differ")
        del got, again, want, simt
        if h0 is None and dhf is None:
            plain = None
            if S <= 128:
                leaves = [t.detach().requires_grad_(True) for t in args[:5]]
                y_plain = ssm_scan(*leaves, impl="torch")[0]

                def plain():
                    return torch.autograd.grad(y_plain, leaves, dy,
                                               retain_graph=True)
            timings[label] = _time_bwd(
                "ssm_scan_bwd bf16", label,
                lambda: SK.ssm_scan_bwd_cuda(xk, dtk, A, Bk, Ck, None, dyk),
                plain, ssd_bwd_bounds(B, S, H, P, N, G, esize=2,
                                      dt_esize=dt.element_size(),
                                      rate=H100_BF16_FLOPS),
                rate_name="bf16's 989 TFLOP/s",
                other=("simt_bf16", lambda: SK.ssm_scan_bwd_cuda(
                    xk, dtk, A, Bk, Ck, None, dyk, variant="simt_bf16")))
            del plain
        del x, dt, A, Bm, Cm, h0, dy, dhf, args, xk, dtk, Bk, Ck, dyk
        torch.cuda.empty_cache()
    return {"name": "ssm_scan_bwd_bf16", "route": "cuda",
            "source": "src/repro_torch/csrc/ssm_scan_bwd_mma.cu",
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:66",
            "replaces_note": "the gradient of ssm_scan_pallas on bf16 x, B "
            "and C (ssd_bwd_mma: the chunk products on mma.sync with the "
            "fp32 factors as two bf16 terms, each gradient rounded once to "
            "its input's dtype); the JAX package has no backward kernel",
            "counter": "ssm_scan_bwd", "counted_variant": "mma_bf16",
            "launches": None, "max_abs_err": max_err,
            "simt_bf16_max_abs_err": simt_worst,
            **timings["zamba2-1.2b training"], "library_ms": None,
            "at": "zamba2-1.2b training shape (B 32, S 128, H 64, P 64, "
            "N 64, G 1, bf16 x/B/C, fp32 dt)", "by_shape": timings}


def train_step_launches(cfg):
    """The kernel launches of one training step of ``cfg`` that the code
    predicts: each block's forward runs twice under remat (the step, then
    its recompute in the backward) and its backward once.  The dense
    stack launches the flash kernels a layer; zamba2 the SSD kernels a
    Mamba2 layer and the flash kernels a shared-attention application;
    RWKV6 the WKV kernels a layer.  Every flash forward under grad writes
    its lse (``flash_attention_lse``)."""
    from repro_torch.models.transformer import _hybrid_segments
    fwd = 2 if cfg.remat else 1
    L = cfg.num_layers
    if cfg.arch_type == "hybrid":
        apps = len(_hybrid_segments(cfg))
        return {"ssm_scan": fwd * L, "ssm_scan_bwd": L,
                "flash_attention": fwd * apps,
                "flash_attention_lse": fwd * apps,
                "flash_attention_bwd": apps}
    if cfg.rwkv is not None:
        return {"rwkv6_scan": fwd * L, "rwkv6_scan_bwd": L}
    return {"flash_attention": fwd * L, "flash_attention_lse": fwd * L,
            "flash_attention_bwd": L}


def train_step_variants(cfg):
    """The variant each kernel of a training step of ``cfg`` launches:
    flash forward and backward and the SSD forward and backward on the
    tensor cores for both dtypes (fp32 in bf16 terms), the WKV forward by
    the compute dtype (fp32 SIMT, bf16 tensor cores), the WKV backward
    SIMT on fp32."""
    bf16 = cfg.compute_dtype == "bfloat16"
    return {"flash_attention": "wgmma" if bf16 else "wgmma_f32",
            "flash_attention_lse": "wgmma" if bf16 else "wgmma_f32",
            "ssm_scan": "mma" if bf16 else "mma_f32",
            "rwkv6_scan": "mma" if bf16 else "simt",
            "flash_attention_bwd": "wgmma_bf16" if bf16 else "wgmma_f32",
            "ssm_scan_bwd": "mma_bf16" if bf16 else "mma_f32",
            "rwkv6_scan_bwd": "simt"}


def phase_train(label, extra, rounds, counters, ckpt=None):
    """``python -m repro_torch.launch.train`` on the card (``main``), with
    every kernel count set to 0 just before it and read just after: a
    finite loss that falls (the last quarter's mean below round 0's),
    ``train_step_launches`` a round, each of the variant
    ``train_step_variants`` names (flash's tensor-core variants of the
    dtype, no SIMT flash launch; the scans' by dtype); ms/round
    over rounds 1 to rounds - 2 (host clock; each round's plan read-back
    waits for the previous round's step), tokens/s, peak device memory.
    Returns the launches, the by-variant launches, the final state and
    ms/round."""
    from repro_torch.configs import scaled_config
    from repro_torch.launch import train as T
    from repro_torch.models import build_model
    args = T.parse_args(extra)
    cfg = scaled_config(args.arch, args.scale)
    argv = extra + ["--device", "cuda", "--rounds", str(rounds),
                    "--log-every", str(rounds)]
    if ckpt:
        argv += ["--ckpt", ckpt]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    state, rows = T.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    variants = {name: dict(c.by_variant) for name, c in counters.items()
                if c.by_variant}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in rows]
    ms = (rows[-1]["t"] - rows[1]["t"]) * 1e3 / (rounds - 2)
    tokens = args.silos * args.batch_per_silo * args.seq_len
    L = cfg.num_layers
    log(f"[{label}] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, "
        f"{build_model(cfg).param_count():,} parameters, "
        f"{cfg.param_dtype} (moments fp32); "
        f"{args.silos} silos x {args.batch_per_silo} x {args.seq_len} "
        f"tokens a round; {rounds} rounds in {wall:.1f} s (set-up and "
        f"data included)")
    log(f"[{label}] loss by round {[round(x, 4) for x in losses]}")
    log(f"[{label}] selected {[r['selected'] for r in rows]} received "
        f"{[r['received'] for r in rows]}")
    log(f"[{label}] {ms:.2f} ms/round over rounds 1-{rounds - 2}, "
        f"{tokens / ms * 1e3:.0f} tok/s; peak device memory {peak:.2f} "
        f"GiB; launches {launches}; by variant {variants}")
    want = {name: 0 for name in counters}
    want.update({k: n * rounds for k, n in train_step_launches(cfg).items()})
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches}, expected {want}")
    kinds = train_step_variants(cfg)
    want = {name: {v: want[name] if v == kinds[name] else 0 for v in by}
            for name, by in variants.items()}
    if variants != want:
        raise RuntimeError(f"{label}: launches by variant {variants}, "
                           f"expected {want}")
    tail = losses[-max(rounds // 4, 1):]
    if not all(math.isfinite(x) for x in losses) or \
            not sum(tail) / len(tail) < losses[0]:
        raise RuntimeError(f"{label}: the loss did not fall from round 0 "
                           f"({losses[0]:.4f}) or is not finite: {losses}")
    return launches, variants, state, ms


def named_leaves(tree, path=""):
    """(path, leaf) of a parameter tree in ``tree_leaves`` order: dict
    keys sorted, per-layer lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree)
                for x in named_leaves(t, f"{path}[{i}]")]
    return [(path, tree)]


def phase_train_grads(label, cfg, params, B, S, relative, counters,
                      full=False):
    """One step's gradients of ``Model.loss`` of ``cfg`` at B x S from
    ``params``, fp32 on the card: ``ExecConfig(attn_impl="cuda")`` (the
    kernels forward under remat and their backward kernels, through
    ``FlashAttentionFn`` / ``SSDScanFn`` / ``WKV6ScanFn``) against
    ``attn_impl="torch"`` (the plain attention and scans by autograd),
    leaf by leaf: every leaf within FLASH_BWD_TOL of max(1, max |g|);
    the leaves whose last name is in ``relative`` also within
    GRAD_ATTN_REL_TOL of their own max |g| (a plain gradient that is
    exactly 0 must stay 0).  The kernel step's launches must be
    ``train_step_launches(cfg)``; launches here compare the kernels with
    the plain version and count for no path.

    With ``full`` (the recurrent stacks at full width) the plain side
    runs each scan's per-step oracle (``per_step_scans``), and where the
    stack has attention (zamba2) the gates above hold the scan kernels
    with the plain attention on both sides (``plain_attention``); the
    whole kernel path, flash kernels too, is then held to
    GRAD_ATTN_REL_TOL of their own max |g| on the kernels' input leaves
    (``relative`` and wq/wk/wv), which a lost gradient fails, and its
    distance in FLASH_BWD_TOL's terms is logged (PERF.md: at 38 layers
    the fp32 flash kernels' drift passes 1e-4 of max(1, max |g|))."""
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.tree import tree_leaves, tree_unflatten
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                        device="cuda")
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    null = contextlib.nullcontext
    steps = train_step_launches(cfg)
    # (pass, attn_impl, plain forms, launches): the kernel passes first
    passes = [("kernels", "cuda", null, steps)]
    if full and "flash_attention" in steps and any(
            k in steps for k in ("ssm_scan", "rwkv6_scan")):
        passes.append(("scan kernels", "cuda", plain_attention,
                       {k: n for k, n in steps.items()
                        if not k.startswith("flash")}))
    passes.append(("plain", "torch", per_step_scans if full else null, {}))
    grads, losses = {}, {}
    for name, impl, forms, expect in passes:
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        before = {k: c.count for k, c in counters.items()}
        with forms():
            loss, _ = model.loss(tree_unflatten(params, leaves), batch,
                                 ExecConfig(attn_impl=impl))
            g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        launched = {k: c.count - before[k] for k, c in counters.items()}
        want = {k: expect.get(k, 0) for k in counters}
        if launched != want:
            raise RuntimeError(f"{label} {name}: launches {launched}, "
                               f"expected {want}")
        grads[name], losses[name] = list(g), float(loss.detach())
        del leaves, loss, g
    names = [path for path, _ in named_leaves(params)]
    gated = passes[1][0] if len(passes) == 3 else "kernels"
    plain = "the per-step scans" if full else "plain"
    for name, *_ in passes[:-1]:
        # the whole kernel path beside the gated scan kernels: the inputs
        # of every kernel held to their own max |g|
        rel = relative if name == gated else relative + ("wq", "wk", "wv")
        worst_abs, worst_rel, smallest = 0.0, 0.0, math.inf
        for path, g, w in zip(names, grads[name], grads["plain"]):
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"{label} {name}: the gradient of {path} "
                                   f"is not finite")
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            worst_abs = max(worst_abs, err / max(1.0, scale))
            if name == gated and err > FLASH_BWD_TOL * max(1.0, scale):
                raise RuntimeError(f"{label} {name}: {path} differs by "
                                   f"{err:.3e}, above "
                                   f"{FLASH_BWD_TOL * max(1.0, scale):.3e}")
            if path.rsplit("/", 1)[-1] not in rel:
                continue
            if scale == 0.0:
                if err:
                    raise RuntimeError(f"{label} {name}: {path} has a "
                                       f"gradient where the plain one is 0")
                continue
            smallest = min(smallest, scale)
            worst_rel = max(worst_rel, err / scale)
            if err > GRAD_ATTN_REL_TOL * scale:
                raise RuntimeError(f"{label} {name}: {path} gradient off by "
                                   f"{err / scale:.3e} of its max "
                                   f"{scale:.3e}")
        log(f"[{label}] {cfg.name}, {cfg.num_layers} layers, "
            f"{model.param_count():,} parameters, B {B} x S {S}, one step "
            f"of Model.loss, {name} against {plain}: loss "
            f"{losses[name]:.6f} / {losses['plain']:.6f}; every leaf within "
            f"{worst_abs:.3e} of max(1, max|g|) (gate "
            + (f"{FLASH_BWD_TOL:.0e}" if name == gated else "none: logged")
            + f"); {'/'.join(rel)} within {worst_rel:.3e} of their own max|g| "
            f"(gate "
            f"{GRAD_ATTN_REL_TOL:.0e}; smallest max|g| {smallest:.3e})")
    del grads
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_attention():
    """The model's attention through the plain version, whatever its
    ``attn_impl`` (the scans keep theirs)."""
    from repro_torch.models import attention as ATT
    flash = ATT.flash_attention_model_layout
    ATT.flash_attention_model_layout = lambda *a, **kw: flash(
        *a, **{**kw, "impl": "torch"})
    try:
        yield
    finally:
        ATT.flash_attention_model_layout = flash


@contextlib.contextmanager
def per_step_scans():
    """The model's plain scans (``attn_impl="torch"``) replaced by the
    per-step oracles ``ssm_scan_ref`` / ``rwkv6_scan_ref`` (through
    ``ops.ssm_scan`` / ``wkv_kernel_adapter`` with ``impl="torch"``), as
    the kernel phases hold the kernels to them.  The model's own chunked
    SSD takes exp of within-chunk cumsums near -180 over its chunk of 256:
    at 38 layers its gradients are 1.8e-4 of max(1, max |g|) from
    float64 (measured on the CPU at zamba2's 10m width, S 1024), above
    the gate, where the per-step oracle's are 1.2e-6 and the kernels'
    algorithm's 1.6e-6."""
    from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TR

    def ssd(xh, dtv, A, Bm, Cm, h0=None, chunk=None):
        y, hf = ssm_scan(xh, dtv, A, Bm, Cm, h0, impl="torch")
        return y.to(xh.dtype), hf
    chunked, hook = SSM._ssd_chunked, TR._wkv_kernel
    SSM._ssd_chunked = ssd
    TR._wkv_kernel = lambda exec_cfg, x: wkv_kernel_adapter(
        exec_cfg.attn_impl)
    try:
        yield
    finally:
        SSM._ssd_chunked, TR._wkv_kernel = chunked, hook


def phase_train_grads_full(label, arch, layers, B, S, relative, counters):
    """``phase_train_grads`` at ``arch``'s full width in fp32 (its depth
    cut to ``layers`` where given), from random weights drawn on the card
    by the model's init laws, seed 0 (``full=True``: the per-step scans
    on the plain side)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch), param_dtype="float32",
                              compute_dtype="float32",
                              **({"num_layers": layers} if layers else {}))
    if layers:
        log(f"[{label}] {arch}'s depth cut from "
            f"{get_config(arch).num_layers} to {layers} layers: two fp32 "
            f"gradient sets of the full stack do not fit in 80 GB")
    gc.collect()
    torch.cuda.empty_cache()
    params = build_model(cfg).init(torch.Generator(device="cuda")
                                   .manual_seed(0))
    phase_train_grads(label, cfg, params, B, S, relative, counters,
                      full=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_grads_bf16(label, arch, B, S, relative, counters,
                           layers=None):
    """One step's gradients of ``Model.loss`` of ``arch`` at full width and
    depth in its own bf16, on the card, three ways from one set of weights
    (seed 0): the kernels in bf16 (``attn_impl="cuda"``: the wgmma flash
    and ``ssd_fwd_mma`` forwards under remat, the bf16 backward kernels),
    the plain path in bf16 (the plain attention and the per-step scans,
    ``per_step_scans``) and the same plain path in fp32 on the weights
    upcast, the oracle.  Per leaf, the kernel path's largest distance
    from the oracle at most BF16_GRAD_RATIO times the bf16 plain path's;
    the kernels' input leaves (``relative`` and wq/wk/wv) also by that
    ratio in L2, and not zero.  With ``layers`` (the depth cut to it) the
    gates are the shallow check's instead: per leaf, the kernel path and
    the bf16 plain path each within SHALLOW_OWN_TOL of the leaf's own max
    |g| and SHALLOW_L2_TOL of its norm from the oracle.
    The kernel step's launches must be ``train_step_launches(cfg)``, each
    of ``train_step_variants``'s variant; launches here count for no
    path."""
    from repro_torch.configs import get_config
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    params = build_model(cfg).init(torch.Generator(device="cuda")
                                   .manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                        device="cuda")
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    null = contextlib.nullcontext
    steps, kinds = train_step_launches(cfg), train_step_variants(cfg)
    passes = [("kernels bf16", cfg, "cuda", null, steps),
              ("plain bf16", cfg, "torch", per_step_scans, {}),
              ("oracle fp32", cfg32, "torch", per_step_scans, {})]
    grads, losses = {}, {}
    for name, c, impl, forms, expect in passes:
        model = build_model(c)
        src = params if c is cfg else tree_map(lambda t: t.float(), params)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(src)]
        before = {k: c_.count for k, c_ in counters.items()}
        by_before = {k: dict(c_.by_variant) for k, c_ in counters.items()}
        t0 = time.perf_counter()
        with forms():
            loss, _ = model.loss(tree_unflatten(src, leaves), batch,
                                 ExecConfig(attn_impl=impl))
            g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = {k: c_.count - before[k] for k, c_ in counters.items()}
        if launched != {k: expect.get(k, 0) for k in counters}:
            raise RuntimeError(f"{label} {name}: launches {launched}, "
                               f"expected {expect}")
        for k, n in expect.items():
            ran = counters[k].by_variant[kinds[k]] - by_before[k][kinds[k]]
            if ran != n:
                raise RuntimeError(f"{label} {name}: {k} launched {ran} "
                                   f"{kinds[k]} of {n}")
        grads[name], losses[name] = list(g), float(loss.detach())
        log(f"[{label}] {name}: loss {losses[name]:.6f}, forward and "
            f"backward in {secs:.1f} s, launches {launched}")
        del leaves, loss, g, src
    truth = grads.pop("oracle fp32")
    names = [path for path, _ in named_leaves(params)]
    rel = relative + ("wq", "wk", "wv")
    rows, failed = [], []
    for path, gk, gp, w in zip(names, grads["kernels bf16"],
                               grads["plain bf16"], truth):
        if gk.dtype != torch.bfloat16 or not bool(torch.isfinite(gk).all()):
            raise RuntimeError(f"{label}: the kernels' gradient of {path} is "
                               f"{gk.dtype} or not finite")
        dk = float((gk.float() - w).abs().max())
        dp = float((gp.float() - w).abs().max())
        scale, norm = float(w.abs().max()), float(w.norm())
        # the L2 distances as shares of the oracle's norm: a lost gradient
        # is 1.0 off there
        lk = float((gk.float() - w).norm()) / norm if norm else 0.0
        lp = float((gp.float() - w).norm()) / norm if norm else 0.0
        ratio = dk / dp if dp else (0.0 if dk == 0 else math.inf)
        rows.append((ratio, path, dk, dp, scale, lk, lp))
        if layers:
            for who, d, l2 in (("kernel", dk, lk), ("bf16 plain", dp, lp)):
                if d > SHALLOW_OWN_TOL * scale or l2 > SHALLOW_L2_TOL:
                    failed.append(f"{path}: the {who} path {d:.3e} from the "
                                  f"fp32 oracle, its own max |g| "
                                  f"{scale:.3e}; L2 {l2:.3e} of the "
                                  f"oracle's norm (gates "
                                  f"{SHALLOW_OWN_TOL}, {SHALLOW_L2_TOL})")
            continue
        if dk > BF16_GRAD_RATIO * dp:
            failed.append(f"{path}: {dk:.3e} from the fp32 oracle, the bf16 "
                          f"plain path {dp:.3e} (gate {BF16_GRAD_RATIO}x)")
        if path.rsplit("/", 1)[-1] in rel and (
                lk > BF16_GRAD_RATIO * lp or not bool(gk.any())):
            failed.append(f"{path}: {lk:.3e} of the oracle's norm from it, "
                          f"the bf16 plain path {lp:.3e} (gate "
                          f"{BF16_GRAD_RATIO}x), or zero")
    ins = [r for r in rows if r[1].rsplit("/", 1)[-1] in rel]
    log(f"[{label}] {cfg.name}, {cfg.num_layers} layers, "
        f"{build_model(cfg).param_count():,} parameters, bf16, B {B} x S "
        f"{S}: per leaf, the largest distance from the fp32 oracle, kernels "
        f"/ bf16 plain path: largest ratio {max(r[0] for r in rows):.3f} "
        f"(gate {BF16_GRAD_RATIO}), median "
        f"{sorted(r[0] for r in rows)[len(rows) // 2]:.3f} over {len(rows)} "
        f"leaves; the kernels' input leaves {'/'.join(rel)}: L2 distance "
        f"up to {max(r[5] for r in ins):.3e} of the oracle's norm (the bf16 "
        f"plain path {max(r[6] for r in ins):.3e}), L2 ratio up to "
        f"{max(r[5] / r[6] for r in ins if r[6]):.3f} (gate "
        f"{BF16_GRAD_RATIO}), largest distance up to "
        f"{max(r[2] / r[4] for r in ins if r[4]):.3e} of their own max |g| "
        f"(the bf16 plain path {max(r[3] / r[4] for r in ins if r[4]):.3e})")
    for r, path, dk, dp, scale, lk, lp in sorted(rows, key=lambda r: -r[0])[:5]:
        log(f"[{label}]   {path}: kernels {dk:.3e}, plain bf16 {dp:.3e} "
            f"(ratio {r:.3f}), max |g| {scale:.3e}; L2 {lk:.3e} / {lp:.3e}")
    if layers:
        def share(d, scale):
            return d / scale if scale else (0.0 if d == 0 else math.inf)
        log(f"[{label}] depth cut to {layers} of "
            f"{get_config(arch).num_layers} layers: per leaf, the largest "
            f"distance from the fp32 oracle as a share of the leaf's own "
            f"max |g|, kernels up to "
            f"{max(share(r[2], r[4]) for r in rows):.3e}, bf16 plain path "
            f"up to {max(share(r[3], r[4]) for r in rows):.3e} (gate "
            f"{SHALLOW_OWN_TOL}); L2 share kernels up to "
            f"{max(r[5] for r in rows):.3e}, bf16 plain path up to "
            f"{max(r[6] for r in rows):.3e} (gate {SHALLOW_L2_TOL})")
    for kind in rel:
        of = [r for r in ins if r[1].rsplit("/", 1)[-1] == kind]
        near = min(of, key=lambda r: r[6])
        log(f"[{label}]   {kind} ({len(of)} leaves): L2 distance from the "
            f"oracle, of its norm, kernels {min(r[5] for r in of):.3e} to "
            f"{max(r[5] for r in of):.3e}, bf16 plain path "
            f"{min(r[6] for r in of):.3e} to {max(r[6] for r in of):.3e}; "
            f"nearest for the plain path {near[1]}: kernels {near[5]:.3e}, "
            f"plain {near[6]:.3e}")
    if failed:
        raise RuntimeError(f"{label}: " + "; ".join(failed[:5]))
    del grads, truth, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_profile(timed_ms, rounds=7, active=(3, 6), top=12):
    """``torch.profiler`` over rounds 3-5 of a 100m run (the profiler
    stepped once a round through ``main``'s ``progress``): wall, device
    busy and idle share (against the profiled rounds' wall, which the
    profiler's host overhead inflates, and against ``timed_ms``, the
    unprofiled run's ms/round), and the device time of the flash forward
    and backward kernels, cuBLAS's products, the optimizer's multi-tensor
    passes and the other operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.launch import train as T
    lo, hi = active
    sched = schedule(wait=lo - 1, warmup=1, active=hi - lo, repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        _, rows = T.main(["--scale", "100m", "--device", "cuda", "--rounds",
                          str(rounds), "--log-every", str(rounds)],
                         progress=lambda rnd, rec: prof.step())
    n = hi - lo
    wall_ms = (rows[hi]["t"] - rows[lo]["t"]) * 1e3 / n
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.key.startswith("ProfilerStep")]
    busy = sum(e.self_device_time_total for e in device) / 1e3 / n
    groups = {"flash forward": ("flash_fwd",),
              "flash backward": ("flash_bwd",),
              "flash split pre-passes": ("flash_split3",),
              "cuBLAS products": ("gemm", "xmma", "cutlass", "sm90_"),
              "optimizer multi-tensor": ("multi_tensor", "foreach")}
    by_group = {g: 0.0 for g in list(groups) + ["other"]}
    for e in device:
        g = next((g for g, keys in groups.items()
                  if any(key in e.key for key in keys)), "other")
        by_group[g] += e.self_device_time_total / 1e3 / n
    log(f"[train 100m profile] rounds {lo}-{hi - 1}: wall {wall_ms:.2f} "
        f"ms/round under the profiler, device busy {busy:.2f} ms/round "
        f"(idle {1 - busy / wall_ms:.1%}; against the unprofiled "
        f"{timed_ms:.2f} ms/round of [train 100m], idle "
        f"{1 - busy / timed_ms:.1%})")
    for g, ms in by_group.items():
        log(f"[train 100m profile]   {g:24s} {ms:8.2f} ms/round "
            f"({ms / busy:.1%} of device time)")
    host = [e for e in events if e.device_type == DeviceType.CPU
            and not e.key.startswith("ProfilerStep")]
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / n
        log(f"[train 100m profile]   {ms:8.3f} ms/round {ms / busy:6.1%} "
            f"x{e.count // n:<5d} {e.key[:70]}")
    cpu_ms = sum(e.self_cpu_time_total for e in host) / 1e3 / n
    log(f"[train 100m profile]   host operators' self time {cpu_ms:.2f} "
        f"ms/round over {sum(e.count for e in host) // n} operator calls")


def phase_train_card_vs_cpu(arch="flude-paper", scale=None, ckpt=None):
    """The driver at 4 silos x 4 x 32 (``arch`` at ``scale``) on both
    devices from one set of parameters and explore uniforms: selected,
    received and ε identical, the loss within TRAIN_F32_TOL relative; the
    card's run saves ``ckpt`` where given."""
    from repro_torch.configs import scaled_config
    from repro_torch.launch import train as T
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    argv = ["--arch", arch, "--rounds", "4", "--silos", "4", "--seq-len",
            "32", "--log-every", "100"] + (["--scale", scale] if scale
                                           else [])
    cfg = scaled_config(arch, scale)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    u = torch.rand((4, 4), generator=torch.Generator().manual_seed(1))
    rows = {}
    for dev in ("cpu", "cuda"):
        _, rows[dev] = T.main(
            argv + ["--device", dev] + (["--ckpt", ckpt]
                                        if dev == "cuda" and ckpt else []),
            params=tree_map(lambda t: t.to(dev), params),
            explore_uniforms=lambda rnd: u[rnd])
    cpu, card = rows["cpu"], rows["cuda"]
    rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
              for a, b in zip(card, cpu))
    same = all(a[k] == b[k] for a, b in zip(card, cpu)
               for k in ("selected", "received", "epsilon"))
    log(f"[train card vs CPU] {cfg.name}, 4 silos x 4 x 32, 4 rounds: "
        f"selected {[r['selected'] for r in card]} received "
        f"{[r['received'] for r in card]}, identical with ε {same}; loss "
        f"{[round(r['loss'], 5) for r in card]}, max relative gap {rel:.3e}")
    if not same or rel > TRAIN_F32_TOL:
        raise RuntimeError(f"train card vs CPU {cfg.name}: trajectories "
                           f"differ or the loss differs by {rel:.3e}")


def sha256_file(path):
    import hashlib
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def phase_provenance():
    """One SHA-256 of the tree this run executes: over
    ``src/repro_torch/**`` (no bytecode caches) and this script, in sorted
    path order, each file's path and bytes."""
    import hashlib
    root = os.path.join(ROOT, "src", "repro_torch")
    files = sorted(os.path.relpath(os.path.join(d, f), ROOT)
                   for d, dirs, names in os.walk(root)
                   if "__pycache__" not in d for f in names
                   if not f.endswith(".pyc")) + ["chip_smoke.py"]
    h = hashlib.sha256()
    for rel in files:
        h.update(rel.encode() + b"\0")
        with open(os.path.join(ROOT, rel), "rb") as f:
            h.update(f.read())
    log(f"[provenance] tree sha256 {h.hexdigest()} over {len(files)} files "
        f"(src/repro_torch/** and chip_smoke.py, sorted paths)")


def phase_serve_ckpt(ckpt_100m, state_100m):
    """``serve --ckpt``: the 100m checkpoint the training run saved,
    restored bit for bit and served on the card."""
    from repro_torch.checkpoint.checkpointer import restore_like
    from repro_torch.launch import serve as S
    from repro_torch.tree import tree_leaves
    back = restore_like(ckpt_100m, state_100m.params)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back), tree_leaves(state_100m.params)))
    res = S.main(["--arch", "flude-paper", "--scale", "100m", "--ckpt",
                  ckpt_100m, "--device", "cuda", "--batch", "4",
                  "--prompt-len", "128", "--decode-tokens", "16"])
    ok = res.ids.shape == (4, 17) and bool(torch.isfinite(res.logits).all())
    log(f"[serve ckpt] 100m checkpoint ({os.path.getsize(ckpt_100m)} bytes, "
        f"sha256 {sha256_file(ckpt_100m)}) "
        f"restored bit for bit {same}; served 4 x 128 + 16 steps, ids "
        f"{res.ids[0].tolist()}")
    if not (same and ok):
        raise RuntimeError("serve ckpt: the 100m checkpoint did not restore "
                           "or serve")


def phase_serve_ckpt_card_vs_cpu(ckpt_small):
    """The small checkpoint (the card-vs-CPU training run's) restored and
    served on both devices, one prompt.  Its logits are compared
    teacher-forced on the CPU's ids, within SERVE_F32_TOL of max(1,
    |logit|); its free-running ids are reported beside each step's top-2
    margin and may differ only from a near tie on (a step whose top two
    lie within twice that gate), since fp32 summation orders differ
    between the devices in the last bits."""
    from repro_torch.checkpoint.checkpointer import restore_like
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    log(f"[serve ckpt] small checkpoint ({os.path.getsize(ckpt_small)} "
        f"bytes) sha256 {sha256_file(ckpt_small)}")
    model = build_model(get_config("flude-paper"))
    like = model.init(torch.Generator().manual_seed(0))
    params = {"cpu": restore_like(ckpt_small, like),
              "cuda": restore_like(ckpt_small, tree_map(
                  lambda t: t.to("cuda"), like))}
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    cpu, card = (S.serve(model, params[dev], tokens, 20, device=dev)
                 for dev in ("cpu", "cuda"))
    # both devices teacher-forced on the CPU's ids: the logits of the
    # same inputs at every step, whatever the free-running ids did
    forced = {dev: teacher_forced_logits(model, params[dev], tokens,
                                         cpu.ids, dev).cpu()
              for dev in ("cpu", "cuda")}
    scale = forced["cpu"].abs().clamp_min(1.0)
    rel = float(((forced["cuda"] - forced["cpu"]).abs() / scale).max())
    # each step's top-2 margin of the CPU's logits, and the gap within
    # which the logits gate lets the card's argmax differ from the CPU's
    top = forced["cpu"].topk(2, -1)
    margin = top.values[..., 0] - top.values[..., 1]         # (B, steps)
    tie = 2 * SERVE_F32_TOL * top.values[..., 0].abs().clamp_min(1.0)
    diff = card.ids.cpu() != cpu.ids
    same = not bool(diff.any())
    # reruns of one device: the CPU's forced run is its free run again;
    # the card's equals its free run where the ids agreed
    cpu_again = torch.equal(forced["cpu"], cpu.logits)
    card_again = torch.equal(forced["cuda"], card.logits.cpu()) if same \
        else None
    # a free-running id may differ from the CPU's only where its first
    # difference in a row falls on a step whose top two lie within the
    # gate (a near tie); the later steps decode other inputs
    first = [int(row.nonzero()[0]) if bool(row.any()) else None
             for row in diff]
    flips = [(b, t, float(margin[b, t]), float(tie[b, t]))
             for b, t in enumerate(first) if t is not None]
    log(f"[serve ckpt] flude-paper checkpoint of the card's training run, "
        f"2 x 32 + 20 steps: logits teacher-forced on the CPU's ids, card "
        f"vs CPU within {rel:.3e} of max(1, |logit|) (gate "
        f"{SERVE_F32_TOL:.0e}); free-running ids equal {same}; reruns "
        f"bit-identical: CPU {cpu_again}, card {card_again}"
        + (f", first differences (row, step, margin, near-tie gap) {flips}"
           if flips else ""))
    for b in range(margin.shape[0]):
        log(f"[serve ckpt]   row {b} top-2 margin by step "
            f"{[float(f'{m:.3e}') for m in margin[b].tolist()]}; smallest "
            f"{float(margin[b].min()):.3e} (near-tie gap "
            f"{float(tie[b].max()):.1e})")
    if rel > SERVE_F32_TOL:
        raise RuntimeError(f"serve ckpt: teacher-forced logits differ by "
                           f"{rel:.3e} of max(1, |logit|)")
    if any(m > t for _, _, m, t in flips):
        raise RuntimeError(f"serve ckpt: free-running ids differ at a step "
                           f"that is no near tie: {flips}")


def poison_flash_fwd():
    """The fp32 forward (``wgmma_f32``: its term planes, out and lse) at
    ragged shapes, rows that see no key among them, each at the fp32 gate
    and its lse within FLASH_F32_TOL of max(1, |lse|): ``[poison]`` runs
    it with every allocation NaN-filled."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    for label, B, Hq, Hkv, Sq, Sk, D, off, causal, window in (
            ("D 64, q_offset 60, window 50, group 7", 1, 7, 1, 130, 190,
             64, 60, True, 50),
            ("D 80, non-causal window, rows 33.. see no key", 1, 4, 2,
             65, 64, 80, 50, False, 20),
            ("D 32, ragged, group 2", 3, 8, 4, 77, 77, 32, 0, True,
             None)):
        q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Sk, D, torch.float32,
                                seed=Sq + 3)
        kw = dict(causal=causal, window=window, q_offset=off)
        got, lse = FK.flash_attention_cuda(q, k, v, with_lse=True, **kw)
        torch.cuda.synchronize()
        _, note = check_flash(f"poison wgmma_f32 {label}", got, q, k, v,
                              **kw)
        want = attention_lse_ref(q, k, **kw)
        gap = float(((lse - want).abs()
                     / want.abs().clamp_min(1.0)).max())
        log(f"[poison] flash forward wgmma_f32 {label}: {note}; lse "
            f"within {gap:.3e} of max(1, |lse|)")
        if not gap <= FLASH_F32_TOL:
            raise RuntimeError(f"poison flash forward {label}: lse off "
                               f"by {gap:.3e}")
        del q, k, v, got, lse, want


def poison_ssd_fwd():
    """The fp32 SSD forward (``mma_f32``: y and the final state) at a
    ragged shape (S 300, G 2, h0, P 64 / N 64) and at P 32 / N 16 (S 77,
    G 4), each within SSM_REL of the plain version: ``[poison]`` runs it
    with every allocation NaN-filled."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    for label, B, S, H, P, N, G in (("ragged S 300, G 2, h0", 4, 300, 8, 64,
                                     64, 2),
                                    ("ragged S 77, P 32 / N 16, G 4, h0",
                                     1, 77, 8, 32, 16, 4)):
        x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, S, H, P, N, G, torch.float32,
                                           seed=S + 9, with_h0=True)
        before = SK.launches.by_variant["mma_f32"]
        got = ssm_scan(x, dt, A, Bm, Cm, h0)
        torch.cuda.synchronize()
        if SK.launches.by_variant["mma_f32"] != before + 1:
            raise RuntimeError(f"poison ssm_scan {label}: no mma_f32 launch")
        want = ssm_scan(x, dt, A, Bm, Cm, h0, impl="torch")
        ey, ry = _check_scan("poison ssm_scan", label, got[0], want[0],
                             SSM_REL)
        eh, rh = _check_scan("poison ssm_scan", label + " state", got[1],
                             want[1], SSM_REL)
        log(f"[poison] ssm_scan forward mma_f32 {label}: y {ry:.3e}, state "
            f"{rh:.3e} of max(1, |plain|)")
        del x, dt, A, Bm, Cm, h0, got, want


def phase_poison(ckpt_100m, state_100m, ckpt_small):
    """The kernels with every output and workspace their wrappers allocate
    filled with NaN (``_build.poisoned()``, in the place of a memory
    checker, which refuses the card): the fp32 flash forward
    (``wgmma_f32``, out and lse) at three ragged shapes, the fp32 SSD
    forward (``mma_f32``) at two, ``tools/bwd_check.py``'s checks
    (each backward kernel at a ragged shape, ``ssd_bwd_mma`` at two), the
    bf16 SSD backward at SSD_BWD_BF16_CASES' ragged S 300 (four heads a
    block, a workspace) against the per-step oracle, and ``[serve ckpt]``
    (both checkpoints), each at its own unchanged gate.  A kernel that
    leaves an element of what it returns unwritten, or reads one it did
    not write, fails here on every run."""
    import importlib.util
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    spec = importlib.util.spec_from_file_location(
        "bwd_check", os.path.join(ROOT, "tools", "bwd_check.py"))
    bwd_check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bwd_check)
    t0 = time.perf_counter()
    with _build.poisoned():
        poison_flash_fwd()
        poison_ssd_fwd()
        bwd_check.run_checks()
        label, B, S, H, P, N, G, _, _, dt_dtype = next(
            c for c in SSD_BWD_BF16_CASES if c[0].startswith("ragged S 300"))
        x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, S, H, P, N, G, torch.bfloat16,
                                           seed=S + H + 2, with_h0=True)
        gen = torch.Generator(device="cuda").manual_seed(S + 2)
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        dhf = torch.randn((B, H, P, N), generator=gen, device="cuda")
        args = [x, dt.to(dt_dtype), A, Bm, Cm, h0]
        got = _grads(ssm_scan, args, dy, dhf)
        want = _grads(lambda *a: ssm_scan(*a, impl="torch"),
                      [t.float() for t in args], dy, dhf)
        err, rel = check_bf16_grads("poison", f"ssm_scan_bwd {label}",
                                    ("dx", "ddt", "dA", "dB", "dC", "dh0"),
                                    got, want, [t.dtype for t in args],
                                    SSM_BWD_TOL)
        log(f"[poison] ssm_scan_bwd mma_bf16 {label}: largest excess beyond "
            f"one bf16 ulp {err:.3e} ({rel:.3e} of max(1, max |g|))")
        del x, dt, A, Bm, Cm, h0, dy, dhf, args, got, want
        phase_serve_ckpt(ckpt_100m, state_100m)
        phase_serve_ckpt_card_vs_cpu(ckpt_small)
    log(f"[poison] every output and workspace NaN-filled: the fp32 "
        f"forwards, the backward checks, the bf16 SSD backward and [serve "
        f"ckpt] passed their "
        f"gates ({time.perf_counter() - t0:.1f} s)")


def teacher_forced_logits(model, params, tokens, ids, device):
    """``serve``'s prefill and decode loop with the decode inputs taken
    from ``ids`` (B, 1 + steps) in place of each step's argmax: the
    prefill's last logits, then each step's, (B, 1 + steps, vocab)."""
    tokens, ids = tokens.to(device), ids.to(device)
    B, S = tokens.shape
    steps = ids.shape[1] - 1
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": tokens},
                                      max_len=S + steps + 1)
        out = [logits[:, -1]]
        for k in range(steps):
            pos = torch.full((B, 1), S + k, dtype=torch.int32,
                             device=device)
            logits, cache = model.decode_step(params, ids[:, k:k + 1], pos,
                                              cache)
            out.append(logits[:, -1])
    return torch.stack(out, 1)


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
    from repro_torch.configs import scaled_config
    from repro_torch.kernels.fed_agg import kernel as fed_agg_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.robust_agg import kernel as robust_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.ssm_scan import kernel as ssd_kernel
    from repro_torch.launch import train as train_driver
    counters = {"fed_agg": fed_agg_kernel.launches,
                "residual_norms": robust_kernel.launches,
                "flash_attention": flash_kernel.launches,
                "flash_attention_lse": flash_kernel.lse_launches,
                "ssm_scan": ssd_kernel.launches,
                "rwkv6_scan": wkv_kernel.launches,
                "flash_attention_bwd": flash_kernel.bwd_launches,
                "ssm_scan_bwd": ssd_kernel.bwd_launches,
                "rwkv6_scan_bwd": wkv_kernel.bwd_launches}
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 card vs CPU

    name, count, smi = phase_device()
    phase_provenance()
    phase_build()
    entries = {"fed_agg": phase_fed_agg(),
               "residual_norms": phase_residual_norms(),
               "flash_attention": phase_flash_attention(),
               "ssm_scan": phase_ssm_scan(),
               "rwkv6_scan": phase_rwkv6_scan(),
               "flash_attention_bwd": phase_flash_bwd(),
               "flash_attention_bwd_bf16": phase_flash_bwd_bf16(),
               "ssm_scan_bwd": phase_ssm_scan_bwd(),
               "ssm_scan_bwd_bf16": phase_ssm_scan_bwd_bf16(),
               "rwkv6_scan_bwd": phase_rwkv6_scan_bwd()}
    # the fp32 forward (wgmma_f32, what fp32 training and serving run) as
    # an entry of its own: its launches are the wgmma_f32 ones
    fwd32 = phase_flash_fwd_fp32()
    entries["flash_attention_f32"] = {
        "name": "flash_attention_f32", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:69",
        "counter": "flash_attention", "counted_variant": "wgmma_f32",
        "launches": None,
        "max_abs_err": entries["flash_attention"].pop("fp32_max_abs_err"),
        **fwd32["100m S2048"],
        "at": "100m S 2048 training shape (B 8, Hq 12 / Hkv 4, S 2048, D "
        "64, causal, with lse)", "by_shape": fwd32}
    fwd_scans = phase_scan_fwd_fp32()
    entries["rwkv6_scan"]["fp32_training_forward"] = fwd_scans["rwkv6_scan"]
    # the fp32 SSD forward (mma_f32, what fp32 training and prefill run)
    # as an entry of its own: its launches are the mma_f32 ones
    entries["ssm_scan_f32"] = {
        "name": "ssm_scan_f32", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:66",
        "counter": "ssm_scan", "counted_variant": "mma_f32",
        "launches": None,
        "max_abs_err": entries["ssm_scan"].pop("fp32_max_abs_err"),
        **fwd_scans["ssm_scan"]["100m training"],
        "by_shape": fwd_scans["ssm_scan"],
        "float64_distances": ssd_fwd_f64_distances()}
    data, main = phase_main_path(counters)
    dyn, dyn_rows, dyn_peaks = phase_dynamics(data, counters)
    paths = {"main": main, **phase_robust(data, counters), **dyn,
             **phase_cohort(data, counters, dyn_rows, dyn_peaks),
             **phase_thompson(data, counters),
             **phase_telemetry(data, counters, dyn_rows),
             **phase_debug_checks(data, counters, dyn_rows),
             "cohort 1M": phase_cohort_1m(counters)}
    for run in SERVE_RUNS:
        paths[run[0]] = phase_serve(*run, counters)
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt_100m = os.path.join(ckpt_dir, "flude-paper-100m.msgpack")
    for label, extra, rounds in TRAIN_RUNS:
        keep = label == "train 100m"
        paths[label], VARIANT_LAUNCHES[label], state, ms = phase_train(
            label, extra, rounds, counters, ckpt=ckpt_100m if keep else None)
        if keep:
            state_100m, ms_100m = state, ms
            args = train_driver.parse_args(extra)
            phase_train_grads(
                "train 100m grads", scaled_config(args.arch, args.scale),
                state.params, args.silos * args.batch_per_silo,
                args.seq_len, ("wq", "wk", "wv"), counters)
        del state
    for run in TRAIN_GRADS_FULL:
        phase_train_grads_full(*run, counters)
    phase_train_profile(ms_100m)
    ckpt_small = os.path.join(ckpt_dir, "flude-paper.msgpack")
    phase_train_card_vs_cpu(ckpt=ckpt_small)
    phase_train_card_vs_cpu("zamba2-1.2b", "10m")
    phase_train_card_vs_cpu("rwkv6-7b", "10m")
    phase_serve_ckpt(ckpt_100m, state_100m)
    phase_serve_ckpt_card_vs_cpu(ckpt_small)
    phase_poison(ckpt_100m, state_100m, ckpt_small)
    del state_100m
    # zamba2-1.2b in bf16 last: its functional optimizer peaks near 62 GiB
    label, extra, rounds = TRAIN_BF16
    paths[label], VARIANT_LAUNCHES[label], state, _ = phase_train(
        label, extra, rounds, counters)
    del state
    phase_train_grads_bf16(*TRAIN_GRADS_BF16, counters)
    label, arch, B, S, relative = TRAIN_GRADS_BF16
    phase_train_grads_bf16("train grads zamba2 shallow bf16", arch, B, S,
                           relative, counters, layers=SHALLOW_LAYERS)
    for k, entry in entries.items():
        # launches over the driven paths: the FL main, robust, dynamics,
        # cohort, thompson, telemetry (update_norm's fed_agg and
        # residual_norms) and debug_checks runs, the four serve runs and
        # the eight training runs; an entry with a counted variant (the
        # fp32 forward, the backwards) counts that variant's launches only
        counter = entry.pop("counter", k)
        only = entry.get("counted_variant")
        by_path = {p: n[counter] if only is None else
                   VARIANT_LAUNCHES.get(p, {}).get(counter, {}).get(only, 0)
                   for p, n in paths.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    for k in ("flash_attention", "ssm_scan", "rwkv6_scan",
              "flash_attention_bwd", "ssm_scan_bwd", "rwkv6_scan_bwd"):
        entries[k]["launches_by_variant"] = {
            v: sum(n[k][v] for n in VARIANT_LAUNCHES.values())
            for v in counters[k].by_variant}
    # the flash forwards that also wrote their lse (the training ones)
    entries["flash_attention"]["launches_with_lse_by_variant"] = {
        v: sum(n["flash_attention_lse"][v] for n in VARIANT_LAUNCHES.values())
        for v in counters["flash_attention_lse"].by_variant}
    phase_card_vs_cpu()
    phase_serve_card_vs_cpu()
    print(json.dumps({"kernels": list(entries.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
