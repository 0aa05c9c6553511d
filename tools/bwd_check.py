#!/usr/bin/env python3
"""Launch each backward kernel of the port once at a ragged shape and hold
it to autograd through its plain version, on the card.

    python3 tools/bwd_check.py                     # build, check, report
    compute-sanitizer --tool memcheck python3 tools/bwd_check.py

The kernels: those of ``csrc/flash_attention_bwd.cu`` on fp32 (one call
of ``flash_attention_bwd_cuda`` for each fp32 variant, ``wgmma_f32``,
what training runs, with its term-plane workspace and per-head partials,
and ``simt`` by name; D 32, a window, a q_offset, ragged Sq and Sk, after
the fp32 forward, ``flash_fwd_f32``, with and without its log-sum-exp,
its out and lse held to the plain version's; and ``wgmma_f32`` at
D 80, where its dk/dv warpgroups split the two gradients),
``ssd_bwd_simt`` (``csrc/ssm_scan_bwd.cu``: S 130, G 2 with H 4, P 32 /
N 16, h0 and dh_f set), ``ssd_bwd_mma`` (``csrc/ssm_scan_bwd_mma.cu``,
bf16 x, B and C: the same shape, and B 16, S 200, H 64 with P = N = 64,
four heads a block, so that its workspace is written) and ``wkv_bwd_simt``
(``csrc/rwkv6_scan_bwd.cu``: S 77, D 32, s0 and dS_f set).  Small
shapes, so that a sanitizer's slowdown stays within minutes.  Exits
non-zero if a kernel does not build, does not launch, or is off by more
than 1e-4 of max(1, max |g|) (the bf16 kernel: its excess beyond one
bf16 ulp above 2e-4 of max(1, max |g|) or 1e-3 of max |g|,
``ref.bf16_grad_gate``).  ``chip_smoke.py``'s ``[poison]`` phase runs
``run_checks`` with every output and workspace NaN-filled.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

TOL = 1e-4


def check(tag, got, want):
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{tag}: gradient {i} {tuple(g.shape)} or "
                               f"non-finite")
        err = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
        worst = max(worst, err)
    print(f"[bwd_check] {tag}: max error {worst:.3e} of max(1, max |g|)",
          flush=True)
    if worst > TOL:
        raise RuntimeError(f"{tag}: error {worst:.3e} above {TOL}")


def check_bf16(tag, got, want, tol=2e-4):
    from repro_torch.kernels.flash_attention.ref import bf16_grad_gate
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{tag}: gradient {i} {tuple(g.shape)} or "
                               f"non-finite")
        exc, top, ok = bf16_grad_gate(g, w, tol)
        worst = max(worst, exc / max(1.0, top))
        if not ok:
            raise RuntimeError(f"{tag}: gradient {i} off by {exc:.3e} "
                               f"beyond one bf16 ulp, max |g| {top:.3e}")
    print(f"[bwd_check] {tag}: largest excess beyond one bf16 ulp "
          f"{worst:.3e} of max(1, max |g|)", flush=True)


def main():
    if not torch.cuda.is_available():
        print("bwd_check: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    run_checks()
    print("[bwd_check] ok", flush=True)
    return 0


def run_checks():
    """Build and check each backward kernel once (raises on a fault)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_lse_ref, attention_ref)
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    _build.build_all(["flash_attention", "flash_attention_bwd", "ssm_scan",
                      "ssm_scan_bwd", "ssm_scan_bwd_mma", "rwkv6_scan",
                      "rwkv6_scan_bwd"])
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    # flash: the forward without and with lse, then the backward
    q, k, v = rn(2, 4, 97, 32), rn(2, 2, 130, 32), rn(2, 2, 130, 32)
    kw = dict(causal=True, window=50, q_offset=33)
    alone = FK.flash_attention_cuda(q, k, v, **kw)
    out, lse = FK.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    check("flash_attention wgmma_f32 D32 window 50 q_offset 33 (out, lse)",
          (alone, out, lse), (attention_ref(q, k, v, **kw),) * 2
          + (attention_lse_ref(q, k, **kw),))
    dout = rn(*q.shape)
    want = attention_bwd_ref(q, k, v, dout, **kw)
    for variant in ("wgmma_f32", "simt"):
        got = FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                          variant=variant, **kw)
        torch.cuda.synchronize()
        check(f"flash_attention_bwd {variant} D32 window 50 q_offset 33",
              got, want)
    q, k, v, dout = rn(2, 4, 97, 80), rn(2, 2, 97, 80), rn(2, 2, 97, 80), \
        rn(2, 4, 97, 80)
    kw = dict(causal=True, window=40)
    out, lse = FK.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    got = FK.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    check("flash_attention_bwd wgmma_f32 D80 window 40", got,
          attention_bwd_ref(q, k, v, dout, **kw))

    # ssm_scan: kernel layout, groups by index
    B, H, S, P, N, G = 2, 4, 130, 32, 16, 2
    x, Bm, Cm = rn(B, H, S, P, scale=0.5), rn(B, G, S, N, scale=0.5), \
        rn(B, G, S, N, scale=0.5)
    dt = torch.nn.functional.softplus(rn(B, H, S))
    A = -torch.exp(torch.rand((H,), generator=gen, device="cuda") * 2.8)
    h0, dy, dhf = rn(B, H, P, N), rn(B, H, S, P), rn(B, H, P, N)
    SK.ssm_scan_cuda(x, dt, A, Bm, Cm, h0)
    got = SK.ssm_scan_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, dhf)
    torch.cuda.synchronize()
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, Bm, Cm,
                                                        h0)]
    rep = H // G
    y, hf = ssm_scan_ref(leaves[0], leaves[1], leaves[2],
                         leaves[3].repeat_interleave(rep, 1),
                         leaves[4].repeat_interleave(rep, 1), leaves[5])
    want = torch.autograd.grad((y * dy).sum() + (hf * dhf).sum(), leaves)
    check("ssm_scan_bwd S130 H4 G2 P32 N16, h0, dh_f", got, want)

    # ssm_scan_bwd_mma: bf16 x, B and C (the tensor-core kernel); at S 200
    # with 16 x 64 heads of one group a block walks four heads and writes
    # the two middle chunk-start states to its workspace
    bf16 = torch.bfloat16
    for B, H, S, P, N, G in ((2, 4, 130, 32, 16, 2), (16, 64, 200, 64, 64,
                                                      1)):
        x = rn(B, H, S, P, scale=0.5).to(bf16)
        Bm, Cm = (rn(B, G, S, N, scale=0.5).to(bf16) for _ in range(2))
        dt = torch.nn.functional.softplus(rn(B, H, S))
        A = -torch.exp(torch.rand((H,), generator=gen, device="cuda") * 2.8)
        h0, dy, dhf = rn(B, H, P, N), rn(B, H, S, P), rn(B, H, P, N)
        SK.ssm_scan_cuda(x, dt, A, Bm, Cm, h0)
        got = SK.ssm_scan_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, dhf)
        torch.cuda.synchronize()
        leaves = [t.detach().float().requires_grad_(True)
                  for t in (x, dt, A, Bm, Cm, h0)]
        rep = H // G
        y, hf = ssm_scan_ref(leaves[0], leaves[1], leaves[2],
                             leaves[3].repeat_interleave(rep, 1),
                             leaves[4].repeat_interleave(rep, 1), leaves[5])
        want = torch.autograd.grad((y * dy).sum() + (hf * dhf).sum(),
                                   leaves)
        check_bf16(f"ssm_scan_bwd mma_bf16 S{S} H{H} G{G} P{P} N{N} (heads "
                   f"a block {SK.heads_per_block(B, H, G)}), h0, dh_f",
                   got, want)

    # rwkv6_scan
    B, H, S, D = 1, 3, 77, 32
    r, k, v = (rn(B, H, S, D, scale=0.5) for _ in range(3))
    logw = -torch.exp(rn(B, H, S, D, scale=0.5))
    u, s0 = rn(H, D, scale=0.3), rn(B, H, D, D, scale=0.5)
    dy, dsf = rn(B, H, S, D), rn(B, H, D, D)
    WK.rwkv6_scan_cuda(r, k, v, logw, u, s0)
    got = WK.rwkv6_scan_bwd_cuda(r, k, v, logw, u, s0, dy, dsf)
    torch.cuda.synchronize()
    leaves = [t.detach().requires_grad_(True) for t in (r, k, v, logw, u,
                                                        s0)]
    y, sf = rwkv6_scan_ref(*leaves)
    want = torch.autograd.grad((y * dy).sum() + (sf * dsf).sum(), leaves)
    check("rwkv6_scan_bwd S77 H3 D32, s0, dS_f", got, want)


if __name__ == "__main__":
    sys.exit(main())
