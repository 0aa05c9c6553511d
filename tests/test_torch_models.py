"""The port's dense GQA decoder against the JAX reference, on the CPU.

On the same numpy inputs and the reference's own parameters (drawn by
``repro``'s init and handed over with ``repro_torch.convert``):

* the 11 configs, field for field, and their ``reduced()`` variants;
  ``INPUT_SHAPES`` and ``ASSIGNED_ARCHS``;
* the substrate: rms and layer norm, RoPE at theta = 1e6 (the numpy
  float32 frequencies bit for bit), the three MLP activations;
* attention: ``gqa_forward``, ``gqa_prefill`` with the cache larger than
  the prompt and with a sliding-window ring smaller than it, and
  ``gqa_decode_step`` through a ring wrap;
* the model: ``prefill`` then ``decode_step`` against the reference's
  teacher-forced ``forward`` and its own prefill / decode, for
  ``qwen2-7b.reduced()`` and ``h2o-danube-1.8b.reduced()``;
* parameter counts at full width for every dense non-MoE config, from
  the specs alone, and the init laws of ``Model.init``.

Prompts stay at or below 512 tokens: the reference's chunked attention
takes chunks of min(512, S) and needs S divisible by them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.configs import get_config as ref_get_config
from repro.models import ExecConfig as RefExecConfig
from repro.models import attention as RA
from repro.models import build_model as ref_build_model
from repro.models import layers as RL

import repro_torch.configs as PC
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.models import ExecConfig, build_model
from repro_torch.models import attention as A
from repro_torch.models import layers as L

# fp32 throughout; the port and the reference differ in summation order
# (matmul blocking, the attention core's tiling), a few ulps per op over
# two layers
TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
DENSE = [n for n in RC.list_configs()
         if ref_get_config(n).arch_type == "dense"
         and ref_get_config(n).moe is None]


def _np(x):
    return jax.tree.map(np.asarray, jax.device_get(x))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", RC.list_configs())
def test_config_equals_reference(name):
    ref, port = ref_get_config(name), get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.resolved_head_dim == ref.resolved_head_dim


def test_registry_and_input_shapes_equal_reference():
    assert PC.list_configs() == RC.list_configs()
    assert PC.ASSIGNED_ARCHS == RC.ASSIGNED_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in PC.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in RC.INPUT_SHAPES.items()}
    with pytest.raises(KeyError):
        get_config("gpt-5")


# ---------------------------------------------------------------------------
# substrate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(norm):
    cfg = get_config("qwen2-7b").reduced(norm=norm)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32) * 3
    p = {"scale": rng.randn(cfg.d_model).astype(np.float32),
         "bias": rng.randn(cfg.d_model).astype(np.float32)}
    if norm == "rmsnorm":
        del p["bias"]
    want = RL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), cfg)
    got = L.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    _close(got, want)


def test_rope_matches_reference_at_qwen2_theta():
    theta = get_config("qwen2-7b").rope_theta
    assert theta == 1e6
    for d in (64, 80, 128):
        f_ref, f_port = RL.rope_freqs(d, theta), L.rope_freqs(d, theta)
        assert f_port.dtype == np.float32
        assert np.array_equal(f_port, f_ref)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 40, 3, 128).astype(np.float32)
    pos = (np.arange(40)[None] + np.array([[0], [3000]])).astype(np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(_t(x), _t(pos), theta)
    # cos / sin of angles up to ~3000 rad: a few ulps of the angle.  Both
    # sides form the same float32 angles; evaluated in float64 they give
    # the exact rotation, and each side's distance from it names the side
    # at fault if the two ever disagree
    ang = (pos[..., None].astype(np.float32)
           * L.rope_freqs(128, theta)).astype(np.float64)[..., None, :]
    x1, x2 = np.split(x.astype(np.float64), 2, axis=-1)
    exact = np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                            x1 * np.sin(ang) + x2 * np.cos(ang)], axis=-1)
    port_err = float(np.abs(got.numpy() - exact).max())
    ref_err = float(np.abs(np.asarray(want) - exact).max())
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want, np.float32), rtol=1e-5, atol=5e-5,
        err_msg=f"max error against a float64 evaluation of the same "
                f"float32 angles: port {port_err:.3e}, reference "
                f"{ref_err:.3e}")
    # halves, not interleaved pairs: position 0 is the identity
    assert torch.equal(L.apply_rope(_t(x), torch.zeros(2, 40), theta),
                       _t(x))


@pytest.mark.parametrize("act", ["silu_glu", "gelu", "relu2"])
def test_mlp_matches_reference(act):
    cfg = get_config("qwen2-7b").reduced(mlp_act=act)
    specs = RL.mlp_spec(cfg, cfg.d_model, cfg.d_ff)
    params = _np(RL.init_params(specs, jax.random.key(2)))
    x = np.random.RandomState(3).randn(2, 7, cfg.d_model).astype(np.float32)
    want = RL.apply_mlp(params, jnp.asarray(x), cfg)
    got = L.apply_mlp(params_from_jax(params), _t(x), cfg)
    assert sorted(L.mlp_spec(cfg, cfg.d_model, cfg.d_ff)) == sorted(specs)
    _close(got, want)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_setup(arch, S, seed=0, B=2):
    cfg = get_config(arch).reduced()
    rcfg = ref_get_config(arch).reduced()
    params = _np(RL.init_params(RA.gqa_spec(rcfg), jax.random.key(seed)))
    if cfg.qkv_bias:     # the init law zeros the biases: give them values
        rng = np.random.RandomState(seed)
        params = {k: (rng.randn(*v.shape).astype(np.float32) * 0.1
                      if k.startswith("b") else v)
                  for k, v in params.items()}
    x = np.random.RandomState(seed + 1).randn(B, S, cfg.d_model).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return cfg, rcfg, params, x, pos


@pytest.mark.parametrize("arch", ["qwen2-7b", "h2o-danube-1.8b"])
def test_gqa_forward_matches_reference(arch):
    cfg, rcfg, params, x, pos = _attn_setup(arch, S=48)
    want = RA.gqa_forward(params, jnp.asarray(x), jnp.asarray(pos), rcfg)
    for impl in ("cuda", "torch"):
        got = A.gqa_forward(params_from_jax(params), _t(x), _t(pos), cfg,
                            impl=impl)
        _close(got, want)


@pytest.mark.parametrize("arch,S,max_len", [
    ("qwen2-7b", 24, 30),            # cache larger than the prompt
    ("h2o-danube-1.8b", 40, 47),     # window 16: ring smaller than it
    ("h2o-danube-1.8b", 16, 20),     # ring exactly the prompt
])
def test_gqa_prefill_matches_reference(arch, S, max_len):
    cfg, rcfg, params, x, pos = _attn_setup(arch, S=S)
    rc0 = RA.init_kv_cache(rcfg, 2, max_len)
    want, rcache = RA.gqa_prefill(params, jnp.asarray(x), jnp.asarray(pos),
                                  rcfg, rc0)
    c0 = A.init_kv_cache(cfg, 2, max_len, device="cpu")
    got, cache = A.gqa_prefill(params_from_jax(params), _t(x), _t(pos), cfg,
                               c0)
    _close(got, want)
    assert cache.k.shape == rcache.k.shape
    _close(cache.k, rcache.k)
    _close(cache.v, rcache.v)
    assert np.array_equal(cache.length.numpy(), _np(rcache.length))


@pytest.mark.parametrize("arch,S,steps", [
    ("qwen2-7b", 10, 5),
    ("h2o-danube-1.8b", 12, 9),      # ring of 16 wraps at step 4
    ("h2o-danube-1.8b", 40, 5),      # ring prefill, then decode
])
def test_gqa_decode_step_matches_reference_through_a_wrap(arch, S, steps):
    cfg, rcfg, params, x, pos = _attn_setup(arch, S=S + steps, seed=4)
    tp = params_from_jax(params)
    max_len = S + steps + 1
    _, rcache = RA.gqa_prefill(params, jnp.asarray(x[:, :S]),
                               jnp.asarray(pos[:, :S]), rcfg,
                               RA.init_kv_cache(rcfg, 2, max_len))
    _, cache = A.gqa_prefill(tp, _t(x[:, :S]), _t(pos[:, :S]), cfg,
                             A.init_kv_cache(cfg, 2, max_len, device="cpu"))
    for t in range(S, S + steps):
        want, rcache = RA.gqa_decode_step(
            params, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos[:, t:t + 1]),
            rcfg, rcache)
        got, cache = A.gqa_decode_step(tp, _t(x[:, t:t + 1]),
                                       _t(pos[:, t:t + 1]), cfg, cache)
        _close(got, want)
        _close(cache.k, rcache.k)
        _close(cache.v, rcache.v)
        assert np.array_equal(cache.length.numpy(), _np(rcache.length))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _model_pair(arch, seed=0):
    rcfg = ref_get_config(arch).reduced()
    ref = ref_build_model(rcfg)
    rparams = ref.init(jax.random.key(seed))
    port = build_model(get_config(arch).reduced())
    return ref, rparams, port, lm_params_from_jax(_np(rparams),
                                                  rcfg.num_layers)


@pytest.mark.parametrize("arch", ["qwen2-7b", "h2o-danube-1.8b"])
@pytest.mark.parametrize("attn_impl", ["cuda", "torch"])
def test_prefill_then_decode_matches_reference_forward(arch, attn_impl):
    """Prompt 32 (longer than danube-reduced's window of 16: the ring
    prefill), then 6 decode steps, against the reference's teacher-forced
    forward and its own prefill / decode."""
    ref, rparams, port, params = _model_pair(arch)
    B, S, K = 2, 32, 6
    tokens = np.random.RandomState(7).randint(
        0, port.cfg.vocab_size, (B, S + K)).astype(np.int32)
    full = _np(ref.logits(rparams, {"tokens": jnp.asarray(tokens)},
                          RefExecConfig()))
    rl, rcache = ref.prefill(rparams, {"tokens": jnp.asarray(tokens[:, :S])},
                             RefExecConfig(), max_len=S + K)
    ecfg = ExecConfig(attn_impl=attn_impl)
    got = port.logits(params, {"tokens": _t(tokens).long()}, ecfg)
    _close(got, full, TOL)
    lg, cache = port.prefill(params, {"tokens": _t(tokens[:, :S]).long()},
                             ecfg, max_len=S + K)
    assert lg.shape == (B, 1, port.cfg.vocab_size)
    _close(lg, rl, TOL)
    _close(lg[:, 0], full[:, S - 1], TOL)
    for k in range(K - 1):
        t = S + k
        pos = np.full((B, 1), t, np.int32)
        rl, rcache = ref.decode_step(rparams, jnp.asarray(tokens[:, t:t + 1]),
                                     jnp.asarray(pos), rcache)
        lg, cache = port.decode_step(params, _t(tokens[:, t:t + 1]).long(),
                                     _t(pos), cache)
        _close(lg, rl, TOL)
        _close(lg[:, 0], full[:, t], TOL)


@pytest.mark.parametrize("name", DENSE)
def test_param_count_equals_reference_at_full_width(name):
    assert build_model(get_config(name)).param_count() == \
        ref_build_model(ref_get_config(name)).param_count()


def test_qwen2_7b_has_its_published_parameter_count():
    assert build_model(get_config("qwen2-7b")).param_count() == 7_615_616_512


def test_init_follows_the_reference_laws_and_tree():
    cfg = get_config("qwen2-7b").reduced(d_model=128, d_ff=256)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rparams = jax.eval_shape(lambda: ref_build_model(
        ref_get_config("qwen2-7b").reduced(d_model=128, d_ff=256)).init(
            jax.random.key(0)))
    ref = lm_params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), rparams),
        cfg.num_layers)
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), params)
    assert shapes == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), ref)
    assert sum(t.numel() for t in jax.tree.leaves(params)) == \
        model.param_count()
    blk = params["blocks"][1]
    torch.testing.assert_close(params["embed"].std().item(), 0.02,
                               rtol=0.05, atol=0)
    torch.testing.assert_close(params["lm_head"].std().item(),
                               128 ** -0.5, rtol=0.05, atol=0)
    # attention weights: explicit fan-in = d_model (wq/wk/wv), Hq·hd (wo)
    torch.testing.assert_close(blk["attn"]["wq"].std().item(), 128 ** -0.5,
                               rtol=0.05, atol=0)
    torch.testing.assert_close(blk["attn"]["wo"].std().item(),
                               (4 * 64) ** -0.5, rtol=0.05, atol=0)
    torch.testing.assert_close(blk["mlp"]["wo"]["w"].std().item(),
                               256 ** -0.5, rtol=0.05, atol=0)
    assert torch.equal(blk["norm1"]["scale"], torch.ones(128))
    assert torch.equal(blk["attn"]["bq"], torch.zeros(2, 2, 64))
    # each layer draws its own values
    assert not torch.equal(params["blocks"][0]["attn"]["wq"], blk["attn"]["wq"])


def test_bf16_parameters_convert_bit_for_bit():
    rcfg = ref_get_config("qwen2-7b").reduced(param_dtype="bfloat16",
                                              compute_dtype="bfloat16")
    rparams = _np(ref_build_model(rcfg).init(jax.random.key(1)))
    params = lm_params_from_jax(rparams, rcfg.num_layers)
    assert params["embed"].dtype == torch.bfloat16
    for i in range(rcfg.num_layers):
        want = np.asarray(rparams["blocks"]["attn"]["wq"][i], np.float32)
        assert np.array_equal(
            params["blocks"][i]["attn"]["wq"].float().numpy(), want)


def test_exec_config_takes_cuda_or_torch_only():
    """The reference's fields, and no other: ``attn_impl`` picks the
    attention and both scans."""
    assert [f.name for f in dataclasses.fields(ExecConfig)] == \
        [f.name for f in dataclasses.fields(RefExecConfig)]
    assert ExecConfig().attn_impl == "cuda"
    with pytest.raises(ValueError):
        ExecConfig(attn_impl="chunked")
    with pytest.raises(TypeError):
        ExecConfig(scan_impl="torch")
    with pytest.raises(NotImplementedError, match="#17"):
        ExecConfig(mesh=object())


@pytest.mark.parametrize("knob,item", [
    (dict(q_chunk=128), "Queue B #3"), (dict(k_chunk=256), "Queue B #3"),
    (dict(unroll_causal=True), "Queue B #3"),
    (dict(rules=object()), "#17"), (dict(moe_dispatch="einsum"), "#15d"),
    (dict(seq_shard_resid=True), "#17"), (dict(moe_groups=2), "#15d"),
])
def test_exec_config_rejects_knobs_the_port_does_not_read(knob, item):
    with pytest.raises(NotImplementedError, match=item):
        ExecConfig(**knob)


@pytest.mark.parametrize("name", DENSE + ["zamba2-1.2b"])
def test_every_served_config_has_a_flash_kernel_head_dim(name):
    """The CUDA kernel is compiled for a fixed set of head dims: every
    config the port serves with attention (the dense ones and zamba2's
    shared block), at full width and reduced, is one."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    for cfg in (get_config(name), get_config(name).reduced()):
        assert cfg.resolved_head_dim in HEAD_DIMS, (cfg.name,
                                                    cfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# the stateful families: zamba2 (Mamba2 hybrid) and RWKV6
# ---------------------------------------------------------------------------

STATEFUL = ["zamba2-1.2b", "rwkv6-7b"]


def _stateful_pair(arch, seed=0):
    """The reference's reduced model and its parameters, with every
    constant leaf (zeros or ones by its init law) drawn away from its
    constant, and the port's model with the same parameters."""
    rcfg = ref_get_config(arch).reduced()
    ref = ref_build_model(rcfg)
    rng = np.random.RandomState(seed)

    def draw(v):
        v = np.asarray(v)
        if np.all(v == v.flat[0]):
            v = v + rng.randn(*v.shape).astype(v.dtype) * 0.2
        return np.array(v)
    rparams = jax.tree.map(draw, _np(ref.init(jax.random.key(seed))))
    port = build_model(get_config(arch).reduced())
    return ref, rparams, port, lm_params_from_jax(rparams, rcfg.num_layers)


@pytest.mark.parametrize("arch", STATEFUL)
@pytest.mark.parametrize("attn_impl", ["cuda", "torch"])
def test_stateful_prefill_then_decode_matches_reference_forward(arch,
                                                                attn_impl):
    """Prompt 70 (past RWKV's S > 64 switch to the chunked form, ragged
    against zamba2-reduced's chunk of 32), then 6 decode steps, against
    the reference's teacher-forced forward and its own prefill / decode,
    as ``tests/test_decode_consistency.py`` holds the reference."""
    ref, rparams, port, params = _stateful_pair(arch)
    B, S, K = 2, 70, 6
    tokens = np.random.RandomState(9).randint(
        0, port.cfg.vocab_size, (B, S + K)).astype(np.int32)
    rparams_j = jax.tree.map(jnp.asarray, rparams)
    full = _np(ref.logits(rparams_j, {"tokens": jnp.asarray(tokens)},
                          RefExecConfig(attn_impl="dense")))
    rl, rcache = ref.prefill(rparams_j, {"tokens": jnp.asarray(
        tokens[:, :S])}, RefExecConfig(attn_impl="dense"), max_len=S + K)
    ecfg = ExecConfig(attn_impl=attn_impl)
    _close(port.logits(params, {"tokens": _t(tokens).long()}, ecfg), full,
           TOL)
    lg, cache = port.prefill(params, {"tokens": _t(tokens[:, :S]).long()},
                             ecfg, max_len=S + K)
    assert lg.shape == (B, 1, port.cfg.vocab_size)
    _close(lg, rl, TOL)
    _close(lg[:, 0], full[:, S - 1], TOL)
    for k in range(K - 1):
        t = S + k
        pos = np.full((B, 1), t, np.int32)
        rl, rcache = ref.decode_step(rparams_j,
                                     jnp.asarray(tokens[:, t:t + 1]),
                                     jnp.asarray(pos), rcache)
        lg, cache = port.decode_step(params, _t(tokens[:, t:t + 1]).long(),
                                     _t(pos), cache)
        _close(lg, rl, TOL)
        _close(lg[:, 0], full[:, t], TOL)


def test_hybrid_cache_holds_one_kv_cache_per_shared_attention():
    cfg = get_config("zamba2-1.2b")
    ref = ref_get_config("zamba2-1.2b")
    from repro.models.transformer import _hybrid_segments as ref_segments
    from repro_torch.models.transformer import _hybrid_segments
    assert _hybrid_segments(cfg) == ref_segments(ref)
    assert len(_hybrid_segments(cfg)) == 7      # before layers 0, 6, …, 36
    red = get_config("zamba2-1.2b").reduced()
    cache = build_model(red).init_cache(2, 40, device="cpu")
    assert len(cache.layers) == red.num_layers
    assert len(cache.extra) == len(_hybrid_segments(red)) == 2
    assert cache.extra[0].k.shape == (2, 40, red.num_kv_heads, 64)
    rwkv = build_model(get_config("rwkv6-7b").reduced()).init_cache(
        2, 40, device="cpu")
    assert rwkv.extra is None and len(rwkv.layers) == 2


@pytest.mark.parametrize("name,count", [("zamba2-1.2b", 1_153_696_640),
                                        ("rwkv6-7b", 7_618_838_528)])
def test_stateful_param_count_equals_reference_at_full_width(name, count):
    got = build_model(get_config(name)).param_count()
    assert got == count == \
        ref_build_model(ref_get_config(name)).param_count()


@pytest.mark.parametrize("arch", STATEFUL)
def test_stateful_trees_convert_and_match_the_port_init(arch):
    """``lm_params_from_jax`` unstacks ``blocks`` / ``mamba`` /
    ``mamba_norm`` layer by layer and carries ``shared_attn`` and ``ln0``
    over as they are; the result has the tree, shapes and dtypes of the
    port's own ``Model.init``."""
    rcfg = ref_get_config(arch).reduced(param_dtype="bfloat16",
                                        compute_dtype="bfloat16")
    rparams = _np(ref_build_model(rcfg).init(jax.random.key(2)))
    params = lm_params_from_jax(rparams, rcfg.num_layers)
    model = build_model(get_config(arch).reduced(param_dtype="bfloat16",
                                                 compute_dtype="bfloat16"))
    own = model.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), params) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), own)
    assert sum(t.numel() for t in jax.tree.leaves(own)) == \
        model.param_count()
    layered = ("mamba", "mamba_norm") if arch == "zamba2-1.2b" \
        else ("blocks",)
    for key in layered:
        for i in range(rcfg.num_layers):
            for got, want in zip(jax.tree.leaves(params[key][i]),
                                 jax.tree.leaves(jax.tree.map(
                                     lambda a: a[i], rparams[key]))):
                assert np.array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    for key in ("shared_attn", "ln0"):
        if key in rparams:
            for got, want in zip(jax.tree.leaves(params[key]),
                                 jax.tree.leaves(rparams[key])):
                assert np.array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_stateful_init_follows_the_reference_laws():
    """Each stacked leaf keeps the fan-in the reference's stacked spec
    reads (dim -2): ``conv_w`` (L, K, C) is drawn at 1/sqrt(K)."""
    cfg = get_config("zamba2-1.2b").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    m = params["mamba"][1]
    d, K = cfg.d_model, cfg.ssm.conv_kernel
    torch.testing.assert_close(m["w_in"].std().item(), d ** -0.5,
                               rtol=0.05, atol=0)
    torch.testing.assert_close(m["conv_w"].std().item(), K ** -0.5,
                               rtol=0.1, atol=0)
    torch.testing.assert_close(m["w_out"].std().item(),
                               (cfg.ssm.expand * d) ** -0.5, rtol=0.05,
                               atol=0)
    assert torch.equal(m["a_log"], torch.zeros_like(m["a_log"]))
    assert torch.equal(params["mamba_norm"][0]["scale"], torch.ones(d))
    assert not torch.equal(params["mamba"][0]["w_in"], m["w_in"])
    rcfg = get_config("rwkv6-7b").reduced()
    blk = build_model(rcfg).init(torch.Generator().manual_seed(0))[
        "blocks"][0]["rwkv"]
    torch.testing.assert_close(blk["cm_wv"].std().item(),
                               rcfg.d_ff ** -0.5, rtol=0.05, atol=0)
    torch.testing.assert_close(blk["w_r"].std().item(),
                               rcfg.d_model ** -0.5, rtol=0.05, atol=0)
