"""The port's Mamba2 block (``repro_torch.models.ssm``) against
``repro.models.ssm``, on the CPU.

From the reference's parameters for ``zamba2-1.2b.reduced()`` (fp32, one
layer, every zero- or one-initialised leaf drawn away from its constant
so that dt_bias, a_log, d_skip, the conv bias and the norm all act) and
the same numpy inputs:

* ``_causal_conv``, ``_ssd_chunked`` and ``_ssd_kernel`` (the kernel's
  route, on the CPU its per-step plain version; ragged S, groups 1 and
  2, a carried h0);
* ``ssm_forward`` under both impls (the same plain path on the CPU),
  with and without
  ``return_state``: output, conv window, SSM state and length;
* ``ssm_decode_step`` from a prefill state, over several steps, against
  the reference's decode from its own prefill state;
* the impl check.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import ssm as RS

from repro_torch.configs import get_config
from repro_torch.models import ssm as S

# fp32 throughout.  The per-step oracle (``_ssd_kernel`` on a CPU tensor)
# against the reference's chunked scan: a few ulps of the decay per step
# (2.5e-5 of max(1, |y|) at chunk 64 over 4096 steps, measured); the
# block's projections and gated norm add a few ulps each
TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(n_groups=1):
    rcfg = ref_get_config("zamba2-1.2b").reduced()
    cfg = get_config("zamba2-1.2b").reduced()
    if n_groups != 1:
        rcfg = dataclasses.replace(
            rcfg, ssm=dataclasses.replace(rcfg.ssm, n_groups=n_groups))
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, n_groups=n_groups))
    return rcfg, cfg


def _params(rcfg, seed=0):
    """One Mamba2 layer of the reference's init, as numpy, with the
    constant leaves drawn away from their constant."""
    p = jax.tree.map(np.asarray, RL.init_params(RS.ssm_spec(rcfg),
                                                jax.random.key(seed)))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in p.items():
        if np.all(v == v.flat[0]):
            v = v + rng.randn(*v.shape).astype(np.float32) * 0.3
        out[k] = np.array(v, np.float32)
    return out


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _tp(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _x(B, S_, d, seed=1):
    return np.random.RandomState(seed).randn(B, S_, d).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


def test_causal_conv_matches_reference():
    rcfg, cfg = _cfgs()
    p = _params(rcfg)
    C = p["conv_w"].shape[1]
    x = _x(2, 13, C)
    _close(S._causal_conv(torch.from_numpy(x), _tp(p), cfg),
           RS._causal_conv(jnp.asarray(x), _jp(p), rcfg), SCAN_TOL)


@pytest.mark.parametrize("S_,G,chunk,with_h0", [
    (64, 1, 32, False), (77, 2, 32, True), (20, 1, 32, True),
    (100, 2, 16, False)])
def test_ssd_chunked_matches_reference(S_, G, chunk, with_h0):
    rng = np.random.RandomState(S_)
    B, H, P, N = 2, 4, 32, 16
    xh = rng.randn(B, S_, H, P).astype(np.float32)
    dtv = (rng.rand(B, S_, H) * 0.8).astype(np.float32)
    A = (-rng.rand(H) - 0.2).astype(np.float32)
    Bm, Cm = (rng.randn(B, S_, G, N).astype(np.float32) for _ in range(2))
    h0 = rng.randn(B, H, P, N).astype(np.float32) if with_h0 else None
    want_y, want_h = RS._ssd_chunked(
        *(jnp.asarray(a) for a in (xh, dtv, A, Bm, Cm)),
        h0=None if h0 is None else jnp.asarray(h0), chunk=chunk)
    got_y, got_h = S._ssd_chunked(
        *(torch.from_numpy(a) for a in (xh, dtv, A, Bm, Cm)),
        h0=None if h0 is None else torch.from_numpy(h0), chunk=chunk)
    _close(got_y, want_y, SCAN_TOL)
    _close(got_h, want_h, SCAN_TOL)


@pytest.mark.parametrize("S_,G,with_h0", [
    (64, 1, False), (77, 2, True), (20, 1, True), (100, 2, False)])
def test_kernel_route_matches_reference_chunked(S_, G, with_h0):
    """``_ssd_kernel``: the model-layout call of ``ops.ssm_scan`` and the
    cast of y, against the reference's ``_ssd_chunked`` at its chunk."""
    rng = np.random.RandomState(S_ + 1)
    B, H, P, N = 2, 4, 32, 16
    xh = rng.randn(B, S_, H, P).astype(np.float32)
    dtv = (rng.rand(B, S_, H) * 0.8).astype(np.float32)
    A = (-rng.rand(H) - 0.2).astype(np.float32)
    Bm, Cm = (rng.randn(B, S_, G, N).astype(np.float32) for _ in range(2))
    h0 = rng.randn(B, H, P, N).astype(np.float32) if with_h0 else None
    want_y, want_h = RS._ssd_chunked(
        *(jnp.asarray(a) for a in (xh, dtv, A, Bm, Cm)),
        h0=None if h0 is None else jnp.asarray(h0), chunk=32)
    got_y, got_h = S._ssd_kernel(
        *(torch.from_numpy(a) for a in (xh, dtv, A, Bm, Cm)),
        h0=None if h0 is None else torch.from_numpy(h0))
    assert got_y.dtype == torch.float32 and got_h.dtype == torch.float32
    _close(got_y, want_y)
    _close(got_h, want_h)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("G", [1, 2])
def test_forward_and_state_match_reference(impl, G):
    rcfg, cfg = _cfgs(G)
    p = _params(rcfg, seed=G)
    x = _x(2, 45, rcfg.d_model)                 # ragged against chunk 32
    want = RS.ssm_forward(_jp(p), jnp.asarray(x), rcfg)
    _close(S.ssm_forward(_tp(p), torch.from_numpy(x), cfg, impl=impl), want)
    want_o, want_st = RS.ssm_forward(_jp(p), jnp.asarray(x), rcfg,
                                     return_state=True)
    got_o, got_st = S.ssm_forward(_tp(p), torch.from_numpy(x), cfg,
                                  return_state=True, impl=impl)
    _close(got_o, want_o)
    # the conv window is the raw projection tail: the same values
    _close(got_st.conv, want_st.conv, SCAN_TOL)
    _close(got_st.ssm, want_st.ssm)
    assert got_st.length.dtype == torch.int32
    assert got_st.length.tolist() == np.asarray(want_st.length).tolist()


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_decode_steps_from_a_prefill_state_match_reference(impl):
    rcfg, cfg = _cfgs()
    p = _params(rcfg, seed=3)
    x = _x(2, 40, rcfg.d_model, seed=4)
    P0 = 34
    _, rst = RS.ssm_forward(_jp(p), jnp.asarray(x[:, :P0]), rcfg,
                            return_state=True)
    _, st = S.ssm_forward(_tp(p), torch.from_numpy(x[:, :P0]), cfg,
                          return_state=True, impl=impl)
    full = RS.ssm_forward(_jp(p), jnp.asarray(x), rcfg)
    for t in range(P0, x.shape[1]):
        ro, rst = RS.ssm_decode_step(_jp(p), jnp.asarray(x[:, t:t + 1]),
                                     rcfg, rst)
        o, st = S.ssm_decode_step(_tp(p), torch.from_numpy(x[:, t:t + 1]),
                                  cfg, st)
        _close(o, ro)
        _close(o[:, 0], np.asarray(full)[:, t])   # = teacher forcing
        _close(st.ssm, rst.ssm)
        _close(st.conv, rst.conv, SCAN_TOL)
        assert st.length.tolist() == np.asarray(rst.length).tolist()


def test_init_state_matches_reference():
    rcfg, cfg = _cfgs()
    want = RS.init_ssm_state(rcfg, 3)
    got = S.init_ssm_state(cfg, 3, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not g.any()
    assert got.ssm.dtype == torch.float32


def test_unknown_impl_raises():
    rcfg, cfg = _cfgs()
    with pytest.raises(ValueError, match="impl"):
        S.ssm_forward(_tp(_params(rcfg)),
                      torch.zeros(1, 4, rcfg.d_model), cfg, impl="xla")
