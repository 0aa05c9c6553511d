"""The port's serve loop against the JAX reference's, on the CPU.

* ``serve()`` against the reference's prefill and greedy decode
  loop (``repro/launch/serve.py:56-80``, jitted as there) on the same
  prompt tokens and the reference's own parameters: ids equal, logits
  within 1e-4 (fp32), for ``qwen2-7b.reduced()`` and
  ``h2o-danube-1.8b.reduced()`` (window 16, prompt 32: the ring prefill,
  then decode steps past the wrap);
* the device rule: ``serve`` and ``main`` raise where there is no card unless
  asked for the CPU; ``--ckpt`` restores a saved checkpoint;
* ``zamba2-1.2b.reduced()`` and ``rwkv6-7b.reduced()`` (prompt 72, 12
  steps) under both scan impls: ids equal, logits within 1e-4, and the
  entry point on the CPU;
* configs outside the dense GQA decoder, the zamba2 hybrid and RWKV6
  raise ``NotImplementedError`` naming theirs.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ExecConfig as RefExecConfig
from repro.models import build_model as ref_build_model

from repro_torch.configs import MLAConfig, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as S
from repro_torch.models import ExecConfig, build_model

TOL = dict(rtol=1e-4, atol=1e-4)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _reference_serve(model, params, tokens, decode_tokens):
    """The reference's serve loop, as ``repro/launch/serve.py`` runs it."""
    B, Sq = tokens.shape
    ecfg = RefExecConfig()
    cap = Sq + decode_tokens + 1
    prefill = jax.jit(lambda p, b: model.prefill(p, b, ecfg, max_len=cap))
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(params, {"tokens": tokens})
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out_tokens, out_logits = [tok], [logits[:, -1]]
    for k in range(decode_tokens):
        pos = jnp.full((B, 1), Sq + k, jnp.int32)
        logits, cache = decode(params, tok, pos, cache)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out_tokens.append(tok)
        out_logits.append(logits[:, -1])
    return (np.asarray(jnp.concatenate(out_tokens, 1)),
            np.asarray(jnp.stack(out_logits, 1)))


@pytest.mark.parametrize("arch", ["qwen2-7b", "h2o-danube-1.8b"])
@pytest.mark.parametrize("attn_impl", ["cuda", "torch"])
def test_serve_matches_reference_serve_loop(arch, attn_impl):
    rcfg = ref_get_config(arch).reduced()
    ref = ref_build_model(rcfg)
    rparams = ref.init(jax.random.key(3))
    B, Sq, N = 2, 32, 20
    tokens = np.random.RandomState(11).randint(
        0, rcfg.vocab_size, (B, Sq)).astype(np.int32)
    want_ids, want_logits = _reference_serve(ref, rparams,
                                             jnp.asarray(tokens), N)

    model = build_model(get_config(arch).reduced())
    params = lm_params_from_jax(jax.tree.map(np.asarray, rparams),
                                rcfg.num_layers)
    res = S.serve(model, params, torch.from_numpy(tokens).long(), N,
                  exec_cfg=ExecConfig(attn_impl=attn_impl), device="cpu")
    assert res.ids.shape == (B, N + 1) and res.logits.shape == \
        (B, N + 1, rcfg.vocab_size)
    np.testing.assert_allclose(res.logits.numpy(), want_logits, **TOL)
    assert np.array_equal(res.ids.numpy(), want_ids)
    assert res.prefill_s > 0 and res.decode_s > 0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
@pytest.mark.parametrize("attn_impl", ["cuda", "torch"])
def test_stateful_serve_matches_reference_serve_loop(arch, attn_impl):
    """The zamba2 hybrid (its KV caches in ``DecodeCache.extra``, its
    Mamba2 states in ``layers``) and RWKV6 (a prompt past the S > 64
    switch of the reference's plain WKV forms) through the same loop."""
    rcfg = ref_get_config(arch).reduced()
    ref = ref_build_model(rcfg)
    rparams = ref.init(jax.random.key(5))
    B, Sq, N = 2, 72, 12
    tokens = np.random.RandomState(13).randint(
        0, rcfg.vocab_size, (B, Sq)).astype(np.int32)
    want_ids, want_logits = _reference_serve(ref, rparams,
                                             jnp.asarray(tokens), N)
    model = build_model(get_config(arch).reduced())
    params = lm_params_from_jax(jax.tree.map(np.asarray, rparams),
                                rcfg.num_layers)
    res = S.serve(model, params, torch.from_numpy(tokens).long(), N,
                  exec_cfg=ExecConfig(attn_impl=attn_impl), device="cpu")
    np.testing.assert_allclose(res.logits.numpy(), want_logits, **TOL)
    assert np.array_equal(res.ids.numpy(), want_ids)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_serve_entry_point_runs_the_stateful_families_on_the_cpu(
        arch, capsys):
    res = S.main(["--arch", arch, "--reduced", "--batch", "2",
                  "--prompt-len", "70", "--decode-tokens", "3",
                  "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"serving {arch}-reduced: ")
    assert res.ids.shape == (2, 4)
    assert bool(torch.isfinite(res.logits).all())


def test_serve_wants_a_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("qwen2-7b").reduced())
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="CUDA card"):
        S.serve(model, params, tokens, 2)
    with pytest.raises(RuntimeError, match="CUDA card"):
        S.main(["--arch", "qwen2-7b", "--reduced"])
    res = S.main(["--arch", "h2o-danube-1.8b", "--reduced", "--batch", "2",
                  "--prompt-len", "24", "--decode-tokens", "3",
                  "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("serving h2o-danube-1.8b-reduced: ")
    assert out[1].startswith("prefill: 2×24 tokens in ")
    assert out[2].startswith("decode: 3 steps × batch 2 in ")
    assert out[3] == f"sampled ids (first request): {res.ids[0].tolist()}"


def test_serving_does_not_import_the_fl_stack():
    code = ("import sys, repro_torch.launch.serve; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[:2] == ['repro_torch', 'fl']))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={**os.environ, "PYTHONPATH": SRC}).stdout
    assert out.strip() == "[]"


def test_ckpt_restores_what_the_port_saved(tmp_path):
    """``--ckpt`` restores a checkpoint into the model's tree (the
    checkpointer's own tests hold it against the reference's files)."""
    from repro_torch.checkpoint.checkpointer import save
    from repro_torch.convert import lm_params_to_jax
    cfg = get_config("qwen2-7b").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(5))
    path = str(tmp_path / "ck.msgpack")
    save(path, lm_params_to_jax(params))
    argv = ["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--decode-tokens", "3"]
    res = S.main(argv + ["--ckpt", path])
    want = S.serve(build_model(cfg), params, torch.randint(
        0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(
            1)), 3, device="cpu")
    assert torch.equal(res.ids, want.ids)
    assert not torch.equal(S.main(argv).ids, res.ids)


@pytest.mark.parametrize("cfg,item", [
    (get_config("mixtral-8x7b"), "#15d"),
    (dataclasses.replace(get_config("qwen2-7b"), attention="mla",
                         mla=MLAConfig()), "#15d"),
    (get_config("phi-3-vision-4.2b"), "#15d"),
    (get_config("whisper-large-v3"), "#15d"),
], ids=["moe", "mla", "vision", "encdec"])
def test_other_families_raise_naming_their_roadmap_item(cfg, item):
    with pytest.raises(NotImplementedError, match=item):
        build_model(cfg)
    with pytest.raises(NotImplementedError, match=item):
        build_model(cfg.reduced())
