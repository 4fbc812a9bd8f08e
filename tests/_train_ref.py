"""The reference side of the training tests (tests/test_torch_train.py,
tests/test_torch_train_moe.py): reduced models carried across, one
batch, and the reference's loss, gradients and train step from one
jitted program a family; the checks both files run."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.optim import make_optimizer as j_make_optimizer
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch import configs as tconfigs
from repro_torch.core import convert
from repro_torch.core.tree import leaves, paths, unflatten
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.optim import make_optimizer
from repro_torch.train.steps import make_train_step

#: jamba's reduced config is one hybrid period of 8 layers, whose
#: reference program takes ~24 s to compile; two layers (a Mamba + MLP
#: layer, then attention + MoE) run the same code on both sides
OVERRIDES = {"jamba-v0.1-52b": dict(n_layers=2, attn_period=2,
                                    attn_offset=1)}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest magnitude
B, T = 2, 16


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny CPU tensors: intra-op threads only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, seed=0, **over):
    cfg = jconfigs.reduced(jconfigs.get_config(arch), **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), **over)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, tcfg, jp, convert.params_from_numpy(jax.device_get(jp))


def _batch(cfg, seed=1, batch=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, T)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab, (batch, T)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)},
            {"tokens": torch.as_tensor(toks), "targets": torch.as_tensor(tgts)})


def _leaf_close(got, want, tol=GRAD_TOL):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got.detach().float().numpy() - want).max()) \
        if want.size else 0.0
    assert err <= tol * max(scale, 1e-30), (err, scale)


def _trees_close(got, want_stacked, tol=GRAD_TOL):
    want = convert.params_from_numpy(want_stacked)
    gp, wp = list(paths(got)), list(paths(want))
    assert [p for p, _ in gp] == [p for p, _ in wp]
    for (path, g), (_, w) in zip(gp, wp):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        _leaf_close(g, w.numpy(), tol)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's loss, metrics and gradients and its train step's
    outputs on one batch, from ONE jitted program (one compile a
    family), with the models and batch both sides start from."""
    cfg, tcfg, jp, tp = _models(arch, **OVERRIDES.get(arch, {}))
    jb, tb = _batch(cfg)
    j_init, _ = j_make_optimizer(cfg)
    step = j_make_train_step(cfg)

    def both(p, o):
        (loss, m), g = jax.value_and_grad(
            lambda q: JM.train_loss(cfg, q, jb), has_aux=True)(p)
        return loss, m, g, step(p, o, jb, jnp.asarray(3, jnp.int32))

    out = jax.device_get(jax.jit(both)(jp, j_init(jp)))
    return cfg, tcfg, tp, tb, out


def check_loss_and_grads(arch):
    cfg, tcfg, tp, tb, (jl, jm, jg, _) = _reference(arch)
    tp = unflatten(tp, [p.detach().clone() for p in leaves(tp)])
    live = [p.requires_grad_() for p in leaves(tp)]
    tl, tm = TM.train_loss(tcfg, tp, tb, kernel_fns=ops.model_kernel_fns())
    grads = torch.autograd.grad(tl, live, allow_unused=True)
    assert tl.dtype == torch.float32 and tl.dim() == 0
    assert _rel(tl.detach(), jl) <= LOSS_RTOL
    tm = {k: v.detach() for k, v in tm.items()}
    for k in ("ce_loss", "aux_loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_RTOL * max(
            abs(float(jm[k])), 1e-3), k
    if cfg.n_experts:
        assert float(tm["aux_loss"]) > 0
    want = convert.params_from_numpy(jg)
    for (path, w), g in zip(paths(want), grads):
        g = torch.zeros_like(w) if g is None else g
        assert g.shape == w.shape, path
        _leaf_close(g, w.numpy())


def check_train_step(arch):
    _, tcfg, tp, tb, (_, _, _, (j_new, j_opt, jm)) = _reference(arch)
    t_init, _ = make_optimizer(tcfg)
    t_new, t_opt, tm = make_train_step(
        tcfg, kernel_fns=ops.model_kernel_fns())(tp, t_init(tp), tb, 3)
    assert set(tm) == set(jm) == {"loss", "ce_loss", "aux_loss",
                                  "grad_norm", "lr"}
    for k in ("loss", "ce_loss", "lr"):
        assert _rel(tm[k], jm[k]) <= LOSS_RTOL, k
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= GRAD_TOL
    assert int(t_opt["step"]) == int(j_opt["step"]) == 1
    _trees_close(t_new, j_new)
    if tcfg.optimizer == "adafactor":       # the stacked statistics
        want = jax.tree.leaves(j_opt["v"])
        got = leaves(t_opt["v"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _leaf_close(g, w)
