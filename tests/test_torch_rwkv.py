"""The port's RWKV6 block (``repro_torch.models.rwkv``) against
``repro.models.rwkv``, on the CPU.

From the reference's parameters for ``rwkv6-7b.reduced()`` (fp32, one
layer, every zero- or one-initialised leaf drawn away from its constant
so that the decay base, the bonus, the five mixes and the LoRA
up-projections all act) and the same numpy inputs:

* ``_token_shift`` (with and without a previous token), ``_ddlerp``;
* ``wkv_recurrence`` and ``wkv_chunked`` (ragged S, a carried state);
* ``time_mix`` below and above the chunked form's S > 64 switch, with
  and without the kernel hook; ``channel_mix``;
* ``rwkv_block`` with ``return_state`` (the normed shift inputs, the WKV
  state, the length), then decode steps from that state against the
  reference's decode from its own, and against teacher forcing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import rwkv as RR

from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6_scan.ops import wkv_kernel_adapter
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R

# fp32 throughout; the two sides differ in summation order (matmul
# blocking, einsum contraction order), a few ulps per op
TOL = dict(rtol=1e-4, atol=1e-4)
EXACT_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs():
    return (ref_get_config("rwkv6-7b").reduced(),
            get_config("rwkv6-7b").reduced())


def _params(rcfg, seed=0):
    """One RWKV6 layer and its two norms from the reference's init, as
    numpy, with the constant leaves drawn away from their constant."""
    spec = {"rwkv": RR.rwkv_spec(rcfg),
            "norm1": RL.norm_spec(rcfg, rcfg.d_model),
            "norm2": RL.norm_spec(rcfg, rcfg.d_model)}
    p = jax.tree.map(np.asarray, RL.init_params(spec, jax.random.key(seed)))
    rng = np.random.RandomState(seed)

    def draw(v):
        if np.all(v == v.flat[0]):
            v = v + rng.randn(*v.shape).astype(np.float32) * 0.3
        return np.array(v, np.float32)
    return jax.tree.map(draw, p)


def _jp(p):
    return jax.tree.map(jnp.asarray, p)


def _tp(p):
    return jax.tree.map(torch.from_numpy, p)


def _x(B, S, d, seed=1):
    return np.random.RandomState(seed).randn(B, S, d).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


def test_token_shift_and_ddlerp_match_reference():
    rcfg, _ = _cfgs()
    p = _params(rcfg)["rwkv"]
    x = _x(2, 9, rcfg.d_model)
    prev = _x(2, 1, rcfg.d_model, seed=2)[:, 0]
    for pv in (None, prev):
        want = RR._token_shift(jnp.asarray(x),
                               None if pv is None else jnp.asarray(pv))
        got = R._token_shift(torch.from_numpy(x),
                             None if pv is None else torch.from_numpy(pv))
        _close(got, want, EXACT_TOL)
    one = R._token_shift(torch.from_numpy(x[:, :1]), torch.from_numpy(prev))
    assert torch.equal(one[:, 0], torch.from_numpy(prev))
    xx = _x(2, 9, rcfg.d_model, seed=3)
    _close(R._ddlerp(_tp(p), torch.from_numpy(x), torch.from_numpy(xx)),
           RR._ddlerp(_jp(p), jnp.asarray(x), jnp.asarray(xx)), EXACT_TOL)


@pytest.mark.parametrize("S,chunk", [(40, 16), (100, 64), (64, 64)])
def test_wkv_forms_match_reference(S, chunk):
    rng = np.random.RandomState(S)
    B, H, D = 2, 3, 32
    r, k, v = (rng.randn(B, S, H, D).astype(np.float32) * 0.5
               for _ in range(3))
    lw = -np.exp(rng.randn(B, S, H, D) * 0.5).astype(np.float32)
    u = (rng.randn(H, D) * 0.3).astype(np.float32)
    s0 = (rng.randn(B, H, D, D) * 0.5).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (r, k, v, lw, u, s0)]
    targs = [torch.from_numpy(a) for a in (r, k, v, lw, u, s0)]
    want_y, want_s = RR.wkv_recurrence(*jargs)
    got_y, got_s = R.wkv_recurrence(*targs)
    _close(got_y, want_y, EXACT_TOL)
    _close(got_s, want_s, EXACT_TOL)
    want_y, want_s = RR.wkv_chunked(*jargs, chunk=chunk)
    got_y, got_s = R.wkv_chunked(*targs, chunk=chunk)
    _close(got_y, want_y, EXACT_TOL)
    _close(got_s, want_s, EXACT_TOL)


@pytest.mark.parametrize("S", [20, 100])
@pytest.mark.parametrize("hook", [False, True])
def test_time_and_channel_mix_match_reference(S, hook):
    """S 20 runs the per-step recurrence, S 100 the chunked form on the
    reference; with the hook the port runs the kernel's plain version."""
    rcfg, cfg = _cfgs()
    p = _params(rcfg, seed=S)["rwkv"]
    x = _x(2, S, rcfg.d_model, seed=S)
    want, want_s = RR.time_mix(_jp(p), jnp.asarray(x), rcfg, None)
    got, got_s = R.time_mix(_tp(p), torch.from_numpy(x), cfg, None,
                            kernel=wkv_kernel_adapter() if hook else None)
    _close(got, want)
    _close(got_s, want_s)
    _close(R.channel_mix(_tp(p), torch.from_numpy(x), None),
           RR.channel_mix(_jp(p), jnp.asarray(x), None))


@pytest.mark.parametrize("hook", [False, True])
def test_block_state_then_decode_steps_match_reference(hook):
    rcfg, cfg = _cfgs()
    p = _params(rcfg, seed=7)
    B, S, K = 2, 70, 5                   # prompt past the S > 64 switch
    x = _x(B, S + K, rcfg.d_model, seed=8)
    kernel = wkv_kernel_adapter() if hook else None
    _, rst = RR.rwkv_block(_jp(p["rwkv"]), jnp.asarray(x[:, :S]), rcfg,
                           _jp(p["norm1"]), _jp(p["norm2"]),
                           return_state=True)
    out, st = R.rwkv_block(_tp(p["rwkv"]), torch.from_numpy(x[:, :S]), cfg,
                           _tp(p["norm1"]), _tp(p["norm2"]),
                           return_state=True, kernel=kernel)
    for got, want in zip(st, rst):
        _close(got, want)
    assert st.length.dtype == torch.int32
    full = RR.rwkv_block(_jp(p["rwkv"]), jnp.asarray(x), rcfg,
                         _jp(p["norm1"]), _jp(p["norm2"]))
    for t in range(S, S + K):
        xt = x[:, t:t + 1]
        # the reference's decode body (repro/models/transformer.py:397-405)
        h = RL.apply_norm(_jp(p["norm1"]), jnp.asarray(xt), rcfg)
        tm, wkv = RR.time_mix(_jp(p["rwkv"]), h, rcfg, rst)
        xo = jnp.asarray(xt) + tm
        h2 = RL.apply_norm(_jp(p["norm2"]), xo, rcfg)
        xo = xo + RR.channel_mix(_jp(p["rwkv"]), h2, rst)
        rst = RR.RWKVState(h[:, -1], h2[:, -1], wkv, rst.length + 1)
        # the port's: time_mix at S = 1, no hook
        ht = L.apply_norm(_tp(p["norm1"]), torch.from_numpy(xt), cfg)
        tm, wkv = R.time_mix(_tp(p["rwkv"]), ht, cfg, st)
        xp = torch.from_numpy(xt) + tm
        h2t = L.apply_norm(_tp(p["norm2"]), xp, cfg)
        xp = xp + R.channel_mix(_tp(p["rwkv"]), h2t, st)
        st = R.RWKVState(ht[:, -1], h2t[:, -1], wkv, st.length + 1)
        _close(xp, xo)
        _close(xp[:, 0], np.asarray(full)[:, t])    # = teacher forcing
        _close(st.wkv, rst.wkv)


def test_init_state_matches_reference():
    rcfg, cfg = _cfgs()
    want = RR.init_rwkv_state(rcfg, 3)
    got = R.init_rwkv_state(cfg, 3, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not g.any()
    assert got.wkv.dtype == torch.float32
