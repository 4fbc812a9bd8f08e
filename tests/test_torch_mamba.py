"""The port's Mamba block (``repro_torch.models.mamba``) against the
reference.

On a reduced jamba-v0.1-52b (d_inner 128, d_state 4, d_conv 4), with
the reference's random parameters carried across and the same numpy
inputs: the depthwise causal convolution, the selective scan from a
zero and a random state, and ``mamba_forward`` fresh (the prefill) and
continuing a carried state (the decode: T = 1, and a longer segment).
Inside the port, a sequence run in two segments with the state carried
equals the sequence run at once.

Float32 at rtol 1e-4 and atol 1e-5 of the largest magnitude, as
tests/test_torch_model.py: both sides run the same float32 operations
(the reference's scan compiled, the port's a Python loop).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import mamba as jmb
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import mamba as tmb

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=ATOL * scale)


def _block(seed=0):
    cfg = reduced(get_config("jamba-v0.1-52b"))
    tcfg = t_reduced(t_get_config("jamba-v0.1-52b"))
    p = jax.device_get(jmb.mamba_init(jax.random.PRNGKey(seed), cfg,
                                      cfg.dtype))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    return cfg, tcfg, p, tp


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_dims_and_init_layout_match_reference():
    cfg, tcfg, want, _ = _block()
    assert tmb.mamba_dims(tcfg) == jmb.mamba_dims(cfg)
    got = tmb.mamba_init(torch.Generator().manual_seed(0), tcfg,
                         torch.bfloat16)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == (torch.float32 if k in ("A_log", "D")
                                else torch.bfloat16), k
    np.testing.assert_array_equal(got["A_log"].numpy(), want["A_log"])
    state = tmb.mamba_state_init(tcfg, 3)
    ref = jmb.mamba_state_init(cfg, 3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == \
        {k: (v.shape, torch.float32) for k, v in ref.items()}


@pytest.mark.parametrize("T", [1, 3, 12])
def test_causal_conv_vs_reference(T):
    rng = np.random.default_rng(T)
    x, w, b = _rand(rng, 2, T, 16), _rand(rng, 4, 16), _rand(rng, 16)
    want = jmb._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tmb._causal_conv(*(torch.as_tensor(a) for a in (x, w, b)))
    _close(got, want)


@pytest.mark.parametrize("random_h0", [False, True])
@pytest.mark.parametrize("T", [1, 9])
def test_ssm_scan_vs_reference(random_h0, T):
    rng = np.random.default_rng(10 + T)
    B, d_in, N = 2, 16, 4
    u = _rand(rng, B, T, d_in)
    dt = np.log1p(np.exp(_rand(rng, B, T, d_in)))          # softplus > 0
    Bs, Cs = _rand(rng, B, T, N), _rand(rng, B, T, N)
    A = -np.exp(_rand(rng, d_in, N, scale=0.5))
    D = _rand(rng, d_in)
    h0 = _rand(rng, B, d_in, N) if random_h0 else np.zeros((B, d_in, N),
                                                           np.float32)
    y, hT = jmb.ssm_scan(*(jnp.asarray(a) for a in (u, dt, Bs, Cs, A, D,
                                                    h0)))
    ty, thT = tmb.ssm_scan(*(torch.as_tensor(a) for a in (u, dt, Bs, Cs, A,
                                                          D, h0)))
    assert ty.dtype == torch.float32 and thT.dtype == torch.float32
    _close(ty, y)
    _close(thT, hT)


@pytest.mark.parametrize("T", [1, 12])
def test_mamba_forward_fresh_vs_reference(T):
    cfg, tcfg, p, tp = _block(1)
    x = _rand(np.random.default_rng(2), 2, T, cfg.d_model)
    out, st = jmb.mamba_forward(p, cfg, jnp.asarray(x))
    tout, tst = tmb.mamba_forward(tp, tcfg, torch.as_tensor(x))
    _close(tout, out)
    assert set(tst) == set(st)
    for k in st:
        assert tst[k].dtype == torch.float32
        assert tuple(tst[k].shape) == st[k].shape
        _close(tst[k], st[k])


@pytest.mark.parametrize("T", [1, 5])
def test_mamba_forward_with_carried_state_vs_reference(T):
    """The decode path (T = 1) and a longer segment from a random
    carried state (conv window and h)."""
    cfg, tcfg, p, tp = _block(2)
    d_in, _, N, d_conv = jmb.mamba_dims(cfg)
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, T, cfg.d_model)
    state = {"conv": _rand(rng, 2, d_conv - 1, d_in),
             "h": _rand(rng, 2, d_in, N, scale=0.3)}
    out, st = jmb.mamba_forward(p, cfg, jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in state.items()})
    tout, tst = tmb.mamba_forward(tp, tcfg, torch.as_tensor(x),
                                  {k: torch.as_tensor(v)
                                   for k, v in state.items()})
    _close(tout, out)
    for k in st:
        _close(tst[k], st[k])


def test_segments_with_carried_state_equal_one_pass():
    """Prefill of 7 tokens, then 3 and 1 more from the carried state,
    gives the outputs and final state of all 11 at once."""
    _, tcfg, _, tp = _block(4)
    x = torch.as_tensor(_rand(np.random.default_rng(5), 2, 11,
                              tcfg.d_model))
    whole, st_whole = tmb.mamba_forward(tp, tcfg, x)
    a, st = tmb.mamba_forward(tp, tcfg, x[:, :7])
    b, st = tmb.mamba_forward(tp, tcfg, x[:, 7:10], st)
    c, st = tmb.mamba_forward(tp, tcfg, x[:, 10:], st)
    np.testing.assert_allclose(torch.cat([a, b, c], 1).numpy(),
                               whole.numpy(), rtol=RTOL, atol=1e-5)
    for k in st:
        np.testing.assert_allclose(st[k].numpy(), st_whole[k].numpy(),
                                   rtol=RTOL, atol=1e-5)
