"""The port's cross-silo LM training (``repro_torch.fl.cross_silo``,
``repro_torch.launch.train``) against the JAX reference's, on the CPU.

* ``lm_dataset``: the arrays identical (numpy draws, one by one);
* ``lm_loss`` (mean and ``per_example``, masked labels, ``acc``) of
  ``flude-paper.reduced()`` (2 layers) on the reference's parameters;
* the gradient of the cross-silo weighted loss, per leaf, against
  ``jax.grad`` through the reference's own ``make_train_step`` (an
  optimizer that hands the gradient back as the new parameters);
* ``remat`` on and off: bit-identical loss and gradients;
* ``make_train_step`` over 4 AdamW steps with a zero-weight round in the
  middle (the parameters and optimizer state unchanged there, ``step``
  advanced), with 1 and 2 microbatches;
* the driver: ``main(["--device", "cpu", "--rounds", "4", ...])`` against
  ``repro.launch.train.main`` from the reference's parameters and its
  explore uniforms, walked from its key chain (``key(seed + 1)``, split
  each round): selected, received and ε identical, the loss within 1e-4
  relative.

Tolerances (fp32 on both sides, other summation orders): losses within
1e-5 relative; gradients within 1e-5 of max(1, max |g|) of each leaf;
parameters after AdamW steps within 1e-4: Adam's update m̂/(√v̂ + eps) is
about ±1 wherever |g| is well above eps = 1e-8, but where a gradient
element is near eps, a last-ulp difference in it moves u by up to ~0.1
(measured: 4.3e-5 at lr 5e-4).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.launch.train as ref_train
from repro.configs import get_config as ref_get_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.data.synthetic import lm_dataset as ref_lm_dataset
from repro.fl import cross_silo as RCS
from repro.models import ExecConfig as RefExecConfig
from repro.models import build_model as ref_build_model
from repro.optim import optimizers as RO

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.synthetic import lm_dataset
from repro_torch.fl import cross_silo as CS
from repro_torch.launch import train as T
from repro_torch.models import ExecConfig, build_model
from repro_torch.optim import optimizers as PO
from repro_torch.tree import tree_leaves

N_SILOS, PER_SILO, SEQ = 4, 2, 32


@pytest.mark.parametrize("n,vocab,seq,n_seq,seed", [
    (4, 512, 16, 8, 0), (3, 4096, 32, 4, 5), (2, 70, 9, 3, 11)])
def test_lm_dataset_is_identical(n, vocab, seq, n_seq, seed):
    got = lm_dataset(n, vocab_size=vocab, seq_len=seq, n_seq=n_seq,
                     seed=seed)
    want = ref_lm_dataset(n, vocab_size=vocab, seq_len=seq, n_seq=n_seq,
                          seed=seed)
    assert got.vocab_size == want.vocab_size
    assert got.tokens.dtype == want.tokens.dtype
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.fixture(scope="module")
def reduced():
    """``flude-paper.reduced()`` in both packages, the reference's
    parameters (seed 0) in both layouts, and a batch of 4 silos x 2 rows
    x 32 tokens with masked labels (row 0's first 5; all of row 3)."""
    rcfg = ref_get_config("flude-paper").reduced()
    ref = ref_build_model(rcfg)
    rparams = ref.init(jax.random.key(0))
    model = build_model(get_config("flude-paper").reduced())
    params = lm_params_from_jax(jax.tree.map(np.asarray, rparams),
                                rcfg.num_layers)
    tok = np.random.RandomState(1).randint(
        0, rcfg.vocab_size, (N_SILOS * PER_SILO, SEQ + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    batch["labels"][0, :5] = -1
    batch["labels"][3] = -1
    return ref, rparams, model, params, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("per_example", [False, True])
def test_lm_loss_matches_reference(reduced, per_example):
    ref, rparams, model, params, batch = reduced
    rloss, rm = jax.jit(lambda p, b: ref.loss(
        p, b, RefExecConfig(), per_example=per_example))(
        rparams, jax.tree.map(jnp.asarray, batch))
    loss, m = model.loss(params, _torch_batch(batch),
                         per_example=per_example)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    keys = ("ce_per_example",) if per_example else ("ce", "acc")
    for k in keys:
        np.testing.assert_allclose(np.asarray(m[k].detach()),
                                   np.asarray(rm[k]), rtol=1e-5, atol=1e-6)
    assert float(m["aux"]) == float(rm["aux"]) == 0.0
    if per_example:     # a fully masked row's CE is 0 (its denominator 1)
        assert float(m["ce_per_example"][3]) == 0.0


class _GradOut:
    """An optimizer whose step returns the gradient as the new parameters:
    the train step's gradient, read through its own code path."""

    def __init__(self, init):
        self.init = init

    def step(self, params, grads, state, **kw):
        return grads, state


def _port_grads(model, params, batch, w, exec_cfg=None, monkeypatch=None):
    monkeypatch.setattr(CS, "make_optimizer",
                        lambda cfg: _GradOut(lambda p: PO.OptState(
                            None, None, torch.zeros((), dtype=torch.int32))))
    step = CS.make_train_step(model, TrainConfig(), N_SILOS, exec_cfg)
    state = CS.TrainState(params, PO.OptState(
        None, None, torch.zeros((), dtype=torch.int32)),
        torch.zeros((), dtype=torch.int32))
    new, metrics = step(state, _torch_batch(batch), torch.from_numpy(w))
    return new.params, metrics["loss"]


def test_weighted_loss_gradient_matches_jax_grad(reduced, monkeypatch):
    ref, rparams, model, params, batch = reduced
    w = np.array([1.0, 0.0, 0.5, 1.0], np.float32)
    monkeypatch.setattr(RCS, "make_optimizer",
                        lambda cfg: _GradOut(lambda p: RO.OptState(
                            None, None, jnp.zeros((), jnp.int32))))
    rstep = jax.jit(RCS.make_train_step(ref, RefTrainConfig(), N_SILOS))
    rstate = RCS.TrainState(rparams, RO.OptState(None, None,
                                                 jnp.zeros((), jnp.int32)),
                            jnp.zeros((), jnp.int32))
    rnew, rmetrics = rstep(rstate, jax.tree.map(jnp.asarray, batch),
                           jnp.asarray(w))
    want = lm_params_from_jax(jax.tree.map(np.asarray, rnew.params), 2)
    got, loss = _port_grads(model, params, batch, w,
                            monkeypatch=monkeypatch)
    assert float(loss) == pytest.approx(float(rmetrics["loss"]), rel=1e-5)
    for g, r in zip(tree_leaves(got), tree_leaves(want)):
        bound = 1e-5 * max(1.0, float(r.abs().max()))
        assert float((g - r).abs().max()) <= bound
    # silo 1 has weight 0: its rows move nothing; every leaf moves
    assert all(bool(g.abs().max() > 0) for g in tree_leaves(got))


def test_remat_on_and_off_are_bit_identical(reduced, monkeypatch):
    """On one thread: MKL sizes its sgemm's threads, and with them its
    blocking and last bits, by the machine's load, so two runs of the
    same product on a loaded machine need not agree bit for bit."""
    _, _, model, params, batch = reduced
    w = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        on, loss_on = _port_grads(model, params, batch, w, ExecConfig(
            remat=True), monkeypatch)
        off, loss_off = _port_grads(model, params, batch, w, ExecConfig(
            remat=False), monkeypatch)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(on),
                                                 tree_leaves(off)))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference_with_an_empty_round(reduced,
                                                          microbatches):
    ref, rparams, model, params, batch = reduced
    tc = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    rstep = jax.jit(RCS.make_train_step(ref, RefTrainConfig(**tc), N_SILOS,
                                        microbatches=microbatches))
    ropt = RO.make_optimizer(RefTrainConfig(**tc))
    rstate = RCS.TrainState(rparams, ropt.init(rparams),
                            jnp.zeros((), jnp.int32))
    opt = PO.make_optimizer(TrainConfig(**tc))
    state = CS.TrainState(
        params, opt.init(params), torch.zeros((), dtype=torch.int32))
    step = CS.make_train_step(model, TrainConfig(**tc), N_SILOS,
                              microbatches=microbatches)
    rb, tb = jax.tree.map(jnp.asarray, batch), _torch_batch(batch)
    weights = [[1, 0, 1, 1], [1, 1, 1, 1], [0, 0, 0, 0], [0, 1, 0, 1]]
    for i, w in enumerate(np.asarray(weights, np.float32)):
        before = state
        rstate, rm = rstep(rstate, rb, jnp.asarray(w))
        state, m = step(state, tb, torch.from_numpy(w))
        assert int(state.step) == int(rstate.step) == i + 1
        assert float(m["received_weight"]) == float(w.sum())
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                                 rel=1e-5, abs=1e-7)
        got = tree_leaves(state.params) + tree_leaves(state.opt_state.mu) \
            + tree_leaves(state.opt_state.nu)
        conv = lm_params_from_jax(jax.tree.map(np.asarray, rstate.params), 2)
        for g, r in zip(tree_leaves(state.params), tree_leaves(conv)):
            assert float((g - r).abs().max()) <= 1e-4
        assert int(state.opt_state.count) == int(rstate.opt_state.count)
        if w.sum() == 0:      # the empty-round gate: nothing moves
            was = tree_leaves(before.params) + tree_leaves(
                before.opt_state.mu) + tree_leaves(before.opt_state.nu)
            assert all(torch.equal(a, b) for a, b in zip(got, was))
            assert torch.equal(state.opt_state.count,
                               before.opt_state.count)
            assert float(m["loss"]) == 0.0


def test_driver_matches_reference_over_four_rounds(monkeypatch):
    argv = ["--rounds", "4", "--silos", "4", "--seq-len", "32",
            "--log-every", "1", "--seed", "0"]
    want = {"loss": [], "selected": [], "received": [], "epsilon": []}

    class JaxRecording:
        """``jax`` as the reference's driver sees it, with a ``jit`` that
        records each step's loss."""

        def __getattr__(self, name):
            return getattr(jax, name)

        def jit(self, fn, **kw):
            jitted = jax.jit(fn, **kw)

            def run(*args):
                out = jitted(*args)
                want["loss"].append(float(out[1]["loss"]))
                return out
            return run

    plan_round, update = ref_core.plan_round, ref_core.update_after_round

    def plan(*args, **kw):
        p = plan_round(*args, **kw)
        want["selected"].append(int(np.asarray(p.selected).sum()))
        return p

    def after(state, plan, received, cfg):
        s = update(state, plan, received, cfg)
        want["received"].append(int(np.asarray(received).sum()))
        want["epsilon"].append(float(s.epsilon))
        return s

    monkeypatch.setattr(ref_core, "plan_round", plan)
    monkeypatch.setattr(ref_core, "update_after_round", after)
    monkeypatch.setattr(ref_train, "jax", JaxRecording())
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    ref_train.main()

    cfg = ref_get_config("flude-paper")
    rparams = ref_build_model(cfg).init(jax.random.key(0))
    params = lm_params_from_jax(jax.tree.map(np.asarray, rparams),
                                cfg.num_layers)
    uniforms, rng = [], jax.random.key(1)        # key(seed + 1)
    for _ in range(4):
        rng, k1 = jax.random.split(rng)
        uniforms.append(torch.from_numpy(np.array(
            jax.random.uniform(k1, (4,)))))
    state, log = T.main(argv + ["--device", "cpu"], params=params,
                        explore_uniforms=lambda rnd: uniforms[rnd])
    assert [r["selected"] for r in log] == want["selected"]
    assert [r["received"] for r in log] == want["received"]
    assert [r["epsilon"] for r in log] == want["epsilon"]
    np.testing.assert_allclose([r["loss"] for r in log], want["loss"],
                               rtol=1e-4)
    assert int(state.step) == 4
    assert sum(want["received"]) > 0


def test_driver_saves_a_checkpoint_and_needs_a_device(tmp_path):
    path = str(tmp_path / "ck" / "t.msgpack")
    _, log = T.main(["--device", "cpu", "--rounds", "2", "--silos", "2",
                     "--seq-len", "16", "--batch-per-silo", "2", "--arch",
                     "flude-paper", "--ckpt", path])
    assert len(log) == 2 and all(np.isfinite(r["loss"]) for r in log)
    from repro.checkpoint.checkpointer import restore
    raw = restore(path)
    assert raw["blocks"]["attn"]["wq"].shape[0] == 4    # stacked layers
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.main(["--rounds", "1"])


def test_exec_config_takes_remat_and_scan_layers():
    """Both read as the reference reads them; scan_layers changes no
    number (the port's layers are a loop)."""
    assert ExecConfig(remat=False).remat is False
    assert ExecConfig(scan_layers=False).scan_layers is False


def test_example_trains_on_the_cpu(capsys):
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_federated_torch.py"
    spec = importlib.util.spec_from_file_location("example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    state, log = example.main(["--device", "cpu", "--rounds", "2",
                               "--silos", "2", "--seq-len", "16"])
    assert len(log) == 2 and int(state.step) == 2
    assert "round    1 loss" in capsys.readouterr().out


def test_init_train_state_and_the_serving_steps(reduced):
    """``init_train_state`` draws the parameters on the generator's device
    beside zero moments and step 0; ``make_prefill_step`` and
    ``make_decode_step`` run the model's prefill and decode step."""
    _, _, model, params, batch = reduced
    state = CS.init_train_state(model, torch.Generator().manual_seed(0),
                                PO.make_optimizer(TrainConfig()))
    assert int(state.step) == 0 and int(state.opt_state.count) == 0
    given = CS.init_train_state(model, torch.Generator().manual_seed(5),
                                PO.make_optimizer(TrainConfig()),
                                params=params)
    assert given.params is params and int(given.step) == 0
    assert all(float(m.abs().max()) == 0.0
               for m in tree_leaves(state.opt_state.mu))
    tokens = torch.from_numpy(batch["tokens"][:2, :8]).long()
    logits, cache = CS.make_prefill_step(model)(params, {"tokens": tokens})
    want, _ = model.prefill(params, {"tokens": tokens})
    assert torch.equal(logits, want)
    nxt = logits[:, -1].argmax(-1)[:, None]
    pos = torch.full((2, 1), 8, dtype=torch.int32)
    step_logits, _ = CS.make_decode_step(model)(params, nxt, pos, cache)
    assert step_logits.shape == (2, 1, model.cfg.vocab_size)
    assert bool(torch.isfinite(step_logits).all())
