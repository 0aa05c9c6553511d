"""The port's optimizers (``repro_torch.optim.optimizers``) against the JAX
reference's (``repro.optim.optimizers``), on the CPU.

* every optimizer kind × ``grad_clip`` on / off × ``moment_dtype`` fp32 /
  bf16, five steps from the same parameters and gradients (numpy, from a
  seed), on a tree with a per-layer list (the reference's stacked
  leaves): parameters and moments after each step;
* ``warmup_cosine`` at steps 0, 1, the warmup's end, mid-run and the
  total, and past it;
* the decay rule on the stacked rank: a per-layer norm scale (d,) in the
  port decays, as the reference's (L, d) leaf does, while a top-level
  (d,) leaf does not;
* ``global_norm`` and ``clip_by_global_norm``.

Tolerances.  Both compute in fp32 with the same formulas and differ by
an ulp here and there (XLA's and torch's pow and sqrt, the order of the
global norm's sum): with fp32 moments, parameters and moments within
1e-6 relative (+1e-6 absolute) after each of five steps.  bf16 moments
are rounded to bf16 after each update, so an fp32 ulp upstream can move
a moment by a bf16 ulp (2^-8 relative): moments within 2^-7 relative,
and the parameters, which move by lr·u with |u| about 1 (lr 1e-3),
within 1e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as RefTrainConfig
from repro.optim import optimizers as RO

from repro_torch.configs.base import TrainConfig
from repro_torch.optim import optimizers as PO
from repro_torch.tree import tree_leaves

L_LAYERS, D = 3, 8


def _ref_tree(rng):
    """The reference's layout: ``blocks`` stacked on a leading layer axis
    (a norm scale (L, d), a weight (L, d, 2d)), top-level (d,) and (v, d)
    leaves."""
    return {"blocks": {"norm": {"scale": rng.randn(L_LAYERS, D)},
                       "w": rng.randn(L_LAYERS, D, 2 * D)},
            "embed": rng.randn(16, D),
            "final_norm": {"scale": rng.randn(D)}}


def _port_tree(ref):
    """The port's layout of the same values: ``blocks`` a list of
    per-layer dicts."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy())
    blocks = ref["blocks"]
    return {"blocks": [{"norm": {"scale": t(blocks["norm"]["scale"][i])},
                        "w": t(blocks["w"][i])} for i in range(L_LAYERS)],
            "embed": t(ref["embed"]),
            "final_norm": {"scale": t(ref["final_norm"]["scale"])}}


def _stacked(port):
    """The port's tree back in the reference's layout, as numpy fp32."""
    def n(x):
        return x.float().numpy()
    return {"blocks": {"norm": {"scale": np.stack(
        [n(b["norm"]["scale"]) for b in port["blocks"]])},
        "w": np.stack([n(b["w"]) for b in port["blocks"]])},
        "embed": n(port["embed"]),
        "final_norm": {"scale": n(port["final_norm"]["scale"])}}


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, rtol, atol):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam", "adamw"])
def test_optimizer_matches_reference_over_five_steps(kind, grad_clip,
                                                     moment_dtype):
    rng = np.random.RandomState(3)
    kw = dict(optimizer=kind, learning_rate=1e-3, warmup_steps=2,
              total_steps=10, grad_clip=grad_clip, moment_dtype=moment_dtype,
              weight_decay=0.1)
    ropt = RO.make_optimizer(RefTrainConfig(**kw))
    popt = PO.make_optimizer(TrainConfig(**kw))
    rparams = _f32(_ref_tree(rng))
    params = _port_tree(rparams)
    rstate, state = ropt.init(rparams), popt.init(params)
    rstep = jax.jit(ropt.step)
    bf16 = moment_dtype == "bfloat16"
    for _ in range(5):
        g = _f32(jax.tree.map(lambda a: a * 0.5, _ref_tree(rng)))
        rparams, rstate = rstep(rparams, g, rstate)
        params, state = popt.step(params, _port_tree(g), state)
        _close(_stacked(params), rparams, rtol=1e-6,
               atol=1e-5 if bf16 else 1e-6)
        assert int(state.count) == int(rstate.count)
        for got, want in ((state.mu, rstate.mu), (state.nu, rstate.nu)):
            assert (got is None) == (want is None)
            if got is not None:
                _close(_stacked(got), want, rtol=2 ** -7 if bf16 else 1e-6,
                       atol=1e-6)
    if kind in ("adam", "adamw"):
        assert tree_leaves(state.mu)[0].dtype == \
            PO.MOMENT_DTYPES[moment_dtype]


@pytest.mark.parametrize("step", [0, 1, 20, 21, 60, 100, 150])
def test_warmup_cosine_matches_reference(step):
    want = float(RO.warmup_cosine(3e-4, 20, 100)(step))
    got = float(PO.warmup_cosine(3e-4, 20, 100)(step))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    got_t = float(PO.warmup_cosine(3e-4, 20, 100)(torch.tensor(step)))
    assert got_t == got


def test_adamw_decays_by_the_reference_stacked_rank():
    """A gradient of zero leaves Adam's update u = 0, so the step is the
    decay alone: p (1 - lr·wd) where the stacked rank is >= 2.  The
    per-layer norm scale (d,) decays (its stacked leaf is (L, d)); the
    top-level final norm (d,) does not; the same as the reference."""
    kw = dict(optimizer="adamw", learning_rate=1e-2, warmup_steps=0,
              total_steps=10, grad_clip=0.0, weight_decay=0.5)
    rparams = _f32(_ref_tree(np.random.RandomState(0)))
    params = _port_tree(rparams)
    zeros = jax.tree.map(np.zeros_like, rparams)
    popt = PO.make_optimizer(TrainConfig(**kw))
    new, _ = popt.step(params, _port_tree(zeros), popt.init(params))
    ropt = RO.make_optimizer(RefTrainConfig(**kw))
    rnew, _ = ropt.step(rparams, zeros, ropt.init(rparams))
    assert PO.stacked_ranks(params) == [2, 3, 2, 3, 2, 3, 2, 1]
    scale0 = params["blocks"][0]["norm"]["scale"]
    assert not torch.equal(new["blocks"][0]["norm"]["scale"], scale0)
    assert torch.equal(new["final_norm"]["scale"],
                       params["final_norm"]["scale"])
    _close(_stacked(new), rnew, rtol=1e-6, atol=1e-7)


def test_global_norm_and_clip_match_reference():
    rng = np.random.RandomState(5)
    g = _f32(_ref_tree(rng))
    want = float(RO.global_norm(g))
    assert float(PO.global_norm(_port_tree(g))) == pytest.approx(want,
                                                                 rel=1e-6)
    clipped, gn = PO.clip_by_global_norm(_port_tree(g), 1.0)
    rclipped, rgn = RO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    assert float(gn) == pytest.approx(float(rgn), rel=1e-6)
    _close(_stacked(clipped), rclipped, rtol=1e-6, atol=1e-7)
    small, _ = PO.clip_by_global_norm(_port_tree(g), 1e9)   # below: as is
    _close(_stacked(small), g, rtol=0, atol=0)


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="lion"):
        PO.make_optimizer(TrainConfig(optimizer="lion"))
