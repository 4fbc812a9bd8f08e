"""The port's optimizers and schedule against the reference, on the CPU.

AdamW, adafactor and ``cosine_warmup`` on the same numpy parameters and
gradients, several steps, every parameter within a few float32 ulp of
its leaf's largest magnitude (``ULPS``: XLA contracts the moments' ``b
* m + (1 - b) * g`` into fused multiply-adds, the port rounds the
product first; they read 1.5-2), the optimizer state within
``STAT_ULPS``.
Adafactor sees the reference's stacked leaves: on a reduced kimi-k2 tree
(a dense prefix layer, then a stack of MoE layers) the port groups its
per-layer leaves back (a stacked 1-D gain is factored across the layers,
the RMS clip spans the stacked leaf) and matches the reference; updated
leaf by leaf it would not, which the last test shows. Then the
reference's own optimizer tests: convergence on a quadratic, the
factored state's size, the schedule's shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim.schedule import cosine_warmup as j_cosine
from repro_torch import configs as tconfigs
from repro_torch.core import convert
from repro_torch.core.tree import leaves, paths
from repro_torch.models.model import stack_plan
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init,
                               adamw_update, cosine_warmup, make_optimizer)

ULPS = 4
#: adafactor's statistics (vr, vc) are means over a row or column of up
#: to 512 squared gradients, reduced in another order than XLA's: 8 ulp
#: (they read 3-4, the parameters 2)
STAT_ULPS = 8


def _ulp_close(got, want, ulps=ULPS):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    tol = ulps * np.spacing(np.float32(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol, err / tol


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((12, 8)).astype(np.float32),
            "b": {"g": rng.standard_normal((8,)).astype(np.float32),
                  "k": rng.standard_normal((3, 5, 4)).astype(np.float32)}}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_vs_reference(name):
    jmod = {"adamw": j_adamw, "adafactor": j_adafactor}[name]
    init = {"adamw": adamw_init, "adafactor": adafactor_init}[name]
    update = {"adamw": adamw_update, "adafactor": adafactor_update}[name]
    jp, tp = _tree(0), _to_torch(_tree(0))
    js = getattr(jmod, f"{name}_init")(jp)
    ts = init(tp)
    j_update = jax.jit(getattr(jmod, f"{name}_update"))
    for step in range(4):
        g = _tree(10 + step)
        lr = float(j_cosine(jnp.asarray(step), peak_lr=1e-2, warmup=2))
        jp, js = j_update(g, js, jp, lr)
        tp, ts = update(_to_torch(g), ts, tp, lr)
        for (_, a), b in zip(paths(tp), jax.tree.leaves(jp)):
            _ulp_close(a, b)
        for (_, a), b in zip(paths(ts), jax.tree.leaves(js)):
            if a.dtype == torch.int32:
                assert int(a) == int(b) == step + 1
            else:
                _ulp_close(a, b, STAT_ULPS if name == "adafactor" else ULPS)


def test_cosine_warmup_vs_reference():
    for step in (0, 1, 50, 99, 100, 101, 5000, 9999, 12000):
        for kw in ({}, dict(peak_lr=1.0, warmup=10, total=100)):
            got = cosine_warmup(step, device="cpu", **kw)
            want = j_cosine(jnp.asarray(step, jnp.int32), **kw)
            assert got.dtype == torch.float32
            _ulp_close(got, want, 1)


def _kimi():
    tcfg = tconfigs.reduced(tconfigs.get_config("kimi-k2-1t-a32b"),
                            n_layers=3)
    cfg = jconfigs.reduced(jconfigs.get_config("kimi-k2-1t-a32b"),
                           n_layers=3)
    jp = jax.device_get(JM.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * (
        1.0 + 9.0 * rng.random())).astype(np.float32), jp)
        for _ in range(3)]
    return cfg, tcfg, jp, grads


def test_adafactor_groups_the_stacked_leaves_vs_reference():
    """Reduced kimi-k2 at 3 layers (a dense ``prefix0``, then a stack
    of 2): ``make_optimizer`` takes adafactor with the stacks grouped,
    the state in the reference's stacked layout; params and state after
    three steps match the reference's."""
    cfg, tcfg, jp, grads = _kimi()
    assert tcfg.optimizer == "adafactor" and stack_plan(tcfg) == (1, 2, 1)
    init, update = make_optimizer(tcfg)
    tp = convert.params_from_numpy(jp)
    ts = init(tp)
    js = j_adafactor.adafactor_init(jp)
    assert [tuple(a.shape) for a in leaves(ts["v"])] == \
        [a.shape for a in jax.tree.leaves(js["v"])]
    # a stacked 1-D gain is factored across the layers
    assert tuple(ts["v"]["stack"]["sub0"]["ln1"]["vc"].shape) == \
        (tcfg.d_model,)
    j_update = jax.jit(j_adafactor.adafactor_update)
    for g in grads:
        jp, js = j_update(g, js, jp, 1e-2)
        tp, ts = update(convert.params_from_numpy(g), ts, tp, 1e-2)
    want = convert.params_from_numpy(jax.device_get(jp))
    for (path, a), (_, b) in zip(paths(tp), paths(want)):
        _ulp_close(a, b.numpy())
    state = convert.opt_state_from_numpy(jax.device_get(js), tp)
    for a, b in zip(leaves(ts), leaves(state)):
        _ulp_close(a, b.numpy(), STAT_ULPS)


def test_adafactor_leaf_by_leaf_is_not_the_reference():
    """Without the grouping (every per-layer leaf on its own) the same
    steps move kimi-k2's parameters elsewhere: the grouping is needed."""
    cfg, tcfg, jp, grads = _kimi()
    tp = convert.params_from_numpy(jp)
    ts = adafactor_init(tp)
    js = j_adafactor.adafactor_init(jp)
    j_update = jax.jit(j_adafactor.adafactor_update)
    for g in grads:
        jp, js = j_update(g, js, jp, 1e-2)
        tp, ts = adafactor_update(convert.params_from_numpy(g), ts, tp, 1e-2)
    want = convert.params_from_numpy(jax.device_get(jp))
    gains = tp["layers"][1]["ln1"], want["layers"][1]["ln1"]
    assert float((gains[0] - gains[1]).abs().max()) > 1e-4


# -- the reference's optimizer tests (tests/test_compression_optim.py) --

def _quadratic_losses(opt_init, opt_update, steps=60, lr=0.1):
    target = torch.tensor([1.0, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = opt_init(params)
    losses = []
    for _ in range(steps):
        grads = {"w": 2.0 * (params["w"] - target)}
        params, state = opt_update(grads, state, params, lr,
                                   weight_decay=0.0)
        losses.append(float(torch.sum((params["w"] - target) ** 2)))
    return losses


def test_adamw_converges():
    losses = _quadratic_losses(adamw_init, adamw_update)
    assert losses[-1] < 1e-2 * losses[0]


def test_adafactor_converges():
    losses = _quadratic_losses(adafactor_init, adafactor_update, lr=0.3)
    assert losses[-1] < 0.05 * losses[0]


def test_adafactor_state_is_factored():
    params = {"big": torch.zeros((128, 64)), "vec": torch.zeros((16,))}
    st_ = adafactor_init(params)
    assert st_["v"]["big"]["vr"].shape == (128,)
    assert st_["v"]["big"]["vc"].shape == (64,)
    assert st_["v"]["vec"]["v"].shape == (16,)
    n_state = sum(x.numel() for x in leaves(st_))
    n_adam = 2 * sum(x.numel() for x in leaves(params))
    assert n_state < n_adam / 10


def test_cosine_warmup_shape():
    lrs = [float(cosine_warmup(s, peak_lr=1.0, warmup=10, total=100,
                               device="cpu")) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0
    assert np.argmax(lrs) <= 12
    assert lrs[-1] < 0.2


def _adamw_formula(grads, m, v, params, lr, step, b1=0.9, b2=0.95, eps=1e-8,
                   weight_decay=0.1):
    """AdamW's leaf update written out, one new tensor an operation."""
    t = torch.tensor(float(step), dtype=torch.float32)
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    out = {}
    for k, p in params.items():
        g = grads[k].float()
        m[k] = b1 * m[k] + (1 - b1) * g
        v[k] = b2 * v[k] + (1 - b2) * g * g
        u = (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
        u = u + weight_decay * p.float()
        out[k] = (p.float() - lr * u).to(p.dtype)
    return out


@pytest.mark.parametrize("lr", [3e-4, "tensor"])
def test_adamw_in_place_update_equals_the_formula(lr):
    """adamw_update computes a leaf's update in place on two scratch
    tensors: bit for bit the formula's, over three steps, for bf16 and
    float32 leaves (the moments updated in the state's own tensors)."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((64, 48), generator=gen).to(torch.bfloat16),
              "router": torch.randn((48, 8), generator=gen),
              "g": torch.randn((48,), generator=gen).to(torch.bfloat16)}
    lr = torch.tensor(3e-4) if lr == "tensor" else lr
    state = adamw_init(params)
    moments = [state["m"]["w"], state["v"]["w"]]
    want, m, v = dict(params), {}, {}
    for k, p in params.items():
        m[k] = torch.zeros(p.shape)
        v[k] = torch.zeros(p.shape)
    got = params
    for step in range(1, 4):
        grads = {k: torch.randn(p.shape, generator=gen).to(p.dtype)
                 for k, p in params.items()}
        got, state = adamw_update(grads, state, got, lr)
        want = _adamw_formula(grads, m, v, want, lr, step)
        for k in params:
            assert got[k].dtype == params[k].dtype
            assert torch.equal(got[k], want[k]), (k, step)
            assert torch.equal(state["m"][k], m[k])
            assert torch.equal(state["v"][k], v[k])
    assert state["m"]["w"] is moments[0] and state["v"]["w"] is moments[1]
