"""The port's MoE FFN (``repro_torch.models.moe``) against the reference.

``moe_apply_pure`` (router, top-k gates, sort-based capacity dispatch,
expert FFN, weighted combine) and its aux loss are compared with the
reference's on reduced mixtral-8x7b (top-2 of 4), jamba-v0.1-52b and a
kimi-k2-like top-8 of 16 experts, with the reference's random
parameters carried across and the same numpy inputs; then the cases
where the two frameworks' primitives could part:

* capacity drops tokens (capacity_factor 0.25): the same tokens are
  dropped, by the same stable sort;
* top-k ties (a uniform router, and two experts with one router
  column): ``jax.lax.top_k`` takes the lower index, and so must the
  port;
* capacity from the call's token count, whatever the batch shape.

Float32 at rtol 1e-4 and atol 1e-5 of the largest magnitude, as
tests/test_torch_model.py; expert indices and capacities exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import moe as jmoe
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import moe as tmoe

RTOL, ATOL = 1e-4, 1e-5
CASES = {
    "mixtral": ("mixtral-8x7b", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "top-8 of 16": ("kimi-k2-1t-a32b", {"n_experts": 16, "top_k": 8}),
}


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=ATOL * scale)


def _moe(case, seed=0, **over):
    arch, base = CASES[case]
    over = {**base, **over}
    cfg = reduced(get_config(arch), **over)
    tcfg = t_reduced(t_get_config(arch), **over)
    p = jax.device_get(jmoe.moe_init(jax.random.PRNGKey(seed), cfg,
                                     cfg.dtype))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    return cfg, tcfg, p, tp


def _x(cfg, B, T, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def _both(cfg, tcfg, p, tp, x):
    y, aux = jmoe.moe_apply_pure(p, cfg, jnp.asarray(x))
    ty, taux = tmoe.moe_apply_pure(tp, tcfg, torch.as_tensor(x))
    return (ty, taux), (y, aux)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("B,T", [(2, 12), (1, 5), (4, 1)])
def test_moe_apply_pure_vs_reference(case, B, T):
    cfg, tcfg, p, tp = _moe(case)
    (ty, taux), (y, aux) = _both(cfg, tcfg, p, tp, _x(cfg, B, T))
    assert ty.dtype == torch.float32 and tuple(ty.shape) == (B, T,
                                                             cfg.d_model)
    _close(ty, y)
    _close(taux, aux)


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_matches_reference_layout(case):
    cfg, tcfg, want, _ = _moe(case)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    got = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg,
                        tcfg.dtype)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
    assert got["router"].dtype == torch.float32
    assert {got[k].dtype for k in ("w_gate", "w_up", "w_down")} == \
        {torch.bfloat16}


@pytest.mark.parametrize("case", ["mixtral", "top-8 of 16"])
def test_capacity_drops_the_same_tokens(case):
    """capacity_factor 0.25 leaves each expert room for fewer tokens
    than the router sends it: the dropped (token, expert) pairs
    contribute nothing, on both sides."""
    cfg, tcfg, p, tp = _moe(case, capacity_factor=0.25)
    B, T = 2, 12
    x = _x(cfg, B, T, seed=2)
    logits = torch.as_tensor(x.reshape(B * T, -1)) @ tp["router"]
    _, idx, _, _ = tmoe._top_k_gates(logits, tcfg.top_k)
    cap = tmoe._capacity(tcfg, B * T, tcfg.n_experts)
    assert cap == jmoe._capacity(cfg, B * T, cfg.n_experts)
    load = torch.bincount(idx.reshape(-1), minlength=tcfg.n_experts)
    assert int(load.max()) > cap                       # tokens are dropped
    (ty, _), (y, _) = _both(cfg, tcfg, p, tp, x)
    _close(ty, y)
    full, _ = tmoe.moe_apply_pure(tp, dataclasses.replace(
        tcfg, capacity_factor=8.0), torch.as_tensor(x))
    assert not torch.allclose(full, ty)                # the drops matter


def test_top_k_ties_take_the_lower_index():
    """A uniform router ties every expert: jax.lax.top_k takes experts
    0..k-1 for every token, and so does the port."""
    cfg, tcfg, _, _ = _moe("top-8 of 16")
    logits = np.zeros((6, cfg.n_experts), np.float32)
    logits[1, 3] = logits[1, 9] = 1.0                  # a tie at the top
    logits[2, :] = np.arange(cfg.n_experts) % 3       # ties in the middle
    g, i, me, ce = jmoe._top_k_gates(jnp.asarray(logits), cfg.top_k)
    tg, ti, tme, tce = tmoe._top_k_gates(torch.as_tensor(logits),
                                         tcfg.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(i))
    assert ti[0].tolist() == list(range(cfg.top_k))
    assert ti[1, :2].tolist() == [3, 9]
    for got, want in ((tg, g), (tme, me), (tce, ce)):
        _close(got, want)


@pytest.mark.parametrize("case", ["mixtral", "top-8 of 16"])
def test_tied_experts_route_as_the_reference(case):
    """Experts 1 and 2 share one router column, so every token ties
    between them: the port picks and weighs them as the reference."""
    cfg, tcfg, p, tp = _moe(case, seed=3)
    router = np.array(p["router"])
    router[:, 2] = router[:, 1]
    p = dict(p, router=router)
    tp = dict(tp, router=torch.as_tensor(router.copy()))
    x = _x(cfg, 2, 12, seed=4)
    (ty, taux), (y, aux) = _both(cfg, tcfg, p, tp, x)
    _close(ty, y)
    _close(taux, aux)


def test_capacity_comes_from_the_call():
    """Capacity is ceil8(int(B T k / E c) + 1) of the call's tokens, as
    the reference: a decode of 4 slots gets capacity 8 whatever the
    batcher's prompt lengths."""
    cfg, tcfg, _, _ = _moe("mixtral")
    for n in (1, 4, 12, 100, 2048):
        assert tmoe._capacity(tcfg, n, tcfg.n_experts) == \
            jmoe._capacity(cfg, n, cfg.n_experts)
    assert tmoe._capacity(tcfg, 4, tcfg.n_experts) == 8


def test_moe_apply_refuses_a_distributed_context():
    """``moe_apply`` is ``moe_apply_pure`` on one device, also under a
    ``DistContext`` without a mesh (to the bit); a ``dist`` that is not
    a ``DistContext`` raises ``TypeError``."""
    cfg, tcfg, _, tp = _moe("mixtral")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, 5, tcfg.d_model)).astype(np.float32))
    y, aux = tmoe.moe_apply(tp, tcfg, x)
    y0, aux0 = tmoe.moe_apply_pure(tp, tcfg, x)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    y1, aux1 = tmoe.moe_apply(tp, tcfg, x, dist=tmoe.DistContext(mesh=None))
    assert torch.equal(y1, y0) and torch.equal(aux1, aux0)
    with pytest.raises(TypeError, match="DistContext"):
        tmoe.moe_apply(tp, tcfg, x, dist=object())
