"""Batched serving: prefill a request batch, decode N tokens.

The port of ``repro.launch.serve``.  Usage (on the card):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --batch 4 --prompt-len 2048 --decode-tokens 32

and on the CPU at a reduced size:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --reduced --device cpu

Weights are drawn at random from ``--seed`` by the reference's init laws
(``Model.init``), or restored from a checkpoint with ``--ckpt`` (one
that ``repro_torch.launch.train --ckpt`` or the reference's driver
saved, in the reference's stacked layout), as the reference's serve
does.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from repro_torch.checkpoint.checkpointer import restore_like
from repro_torch.configs import SCALES, scaled_config
from repro_torch.device import resolve_device
from repro_torch.models import ExecConfig, build_model
from repro_torch.obs.trace import NULL_TRACER


class ServeResult(NamedTuple):
    ids: torch.Tensor         # (B, 1 + decode_tokens) greedy ids, int64
    logits: torch.Tensor      # (B, 1 + decode_tokens, vocab): the prefill's
                              # last-position logits, then each step's
    prefill_s: float          # host clock, after a device synchronise
    decode_s: float


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model, params, tokens: torch.Tensor, decode_tokens: int, *,
          exec_cfg: ExecConfig = ExecConfig(),
          device="cuda", tracer=NULL_TRACER) -> ServeResult:
    """Prefill ``tokens`` (B, S), then ``decode_tokens`` greedy steps.

    The cache holds ``S + decode_tokens + 1`` positions (less for a
    sliding window) and step k decodes position ``S + k``, as the
    reference's serve loop does.  ``params`` must already lie on ``device``;
    ``device`` defaults to the CUDA card and raises where there is none.
    ``tracer`` (``repro_torch.obs.Tracer``) spans the ``prefill`` and
    each ``decode_step``."""
    device = resolve_device(device)
    tokens = tokens.to(device)
    B, S = tokens.shape
    cap = S + decode_tokens + 1
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        with tracer.span("prefill"):
            logits, cache = model.prefill(params, {"tokens": tokens},
                                          exec_cfg, max_len=cap)
        _sync(device)
        prefill_s = time.perf_counter() - t0

        tok = logits[:, -1].argmax(-1)[:, None]
        out_tokens, out_logits = [tok], [logits[:, -1]]
        t0 = time.perf_counter()
        for k in range(decode_tokens):
            pos = torch.full((B, 1), S + k, dtype=torch.int32, device=device)
            with tracer.span("decode_step", step=k):
                logits, cache = model.decode_step(params, tok, pos, cache)
            tok = logits[:, -1].argmax(-1)[:, None]
            out_tokens.append(tok)
            out_logits.append(logits[:, -1])
        _sync(device)
        decode_s = time.perf_counter() - t0
    return ServeResult(torch.cat(out_tokens, 1),
                       torch.stack(out_logits, 1), prefill_s, decode_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="flude-paper")
    ap.add_argument("--scale", default=None, choices=[None, *SCALES])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = scaled_config(args.arch, args.scale)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(
        args.seed))
    if args.ckpt:
        params = restore_like(args.ckpt, params)
    print(f"serving {cfg.name}: {model.param_count() / 1e6:.1f}M params, "
          f"batch={args.batch}")

    B, S = args.batch, args.prompt_len
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=device)
    res = serve(model, params, tokens, args.decode_tokens, device=device)
    print(f"prefill: {B}×{S} tokens in {res.prefill_s * 1e3:.1f} ms "
          f"({B * S / res.prefill_s:.0f} tok/s)")
    print(f"decode: {args.decode_tokens} steps × batch {B} in "
          f"{res.decode_s * 1e3:.1f} ms "
          f"({B * args.decode_tokens / res.decode_s:.0f} tok/s)")
    print("sampled ids (first request):", res.ids[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
