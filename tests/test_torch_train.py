"""The port's training step against the reference, on the CPU.

For every text family (reduced float32 configs; here qwen3-0.6b,
qwen3-8b, rwkv6-7b and granite-34b, and the MLA, MoE and hybrid ones in
tests/test_torch_train_moe.py; the shared machinery in
tests/_train_ref.py) the reference's random parameters are carried
across with ``core.convert.params_from_numpy``, and on one batch of
tokens made with numpy:
  * ``train_loss`` and its gradients against
    ``jax.value_and_grad(repro.models.model.train_loss)``: the loss
    within 1e-5 relative, every gradient leaf (the reference's stacked
    gradients un-stacked like the parameters) within 1e-4 of its
    largest magnitude. Both sides run the same float32 operations in
    other summation orders (XLA fuses and contracts the reference);
  * one ``make_train_step`` (the config's own optimizer: AdamW, and
    adafactor for kimi-k2) against the reference's jitted step: the
    metrics within 1e-5 relative (``grad_norm`` within 1e-4: a float32
    sum over every gradient element in another order), the new
    parameters within 1e-4 of each leaf's scale;
  * two microbatches accumulated in the parameters' dtype against the
    reference's scan, the same bounds.
The kernels' dispatch (``ops.model_kernel_fns()``) takes the plain
versions on CPU tensors, and autograd differentiates those. Remat is
checked by running a config with ``remat=True`` against itself without.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.optim import make_optimizer as j_make_optimizer
from repro.train import steps as JS
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.core.tree import leaves, unflatten
from repro_torch.models import model as TM
from repro_torch.optim import make_optimizer
from repro_torch.train import steps as TS
from repro_torch.train.steps import make_train_step
from tests._train_ref import (GRAD_TOL, LOSS_RTOL, _batch, _models, _rel,
                              _trees_close, check_loss_and_grads,
                              check_train_step, one_thread)  # noqa: F401
from tests.test_torch_model import _assert_caches_close, _close, _merge

ARCHS = ["qwen3-0.6b", "qwen3-8b", "rwkv6-7b", "granite-34b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_vs_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_vs_reference(arch):
    check_train_step(arch)


def test_microbatch_accumulation_vs_reference():
    cfg, tcfg, jp, tp = _models("qwen3-0.6b", microbatches=2)
    jb, tb = _batch(cfg, seed=3, batch=4)
    j_init, _ = j_make_optimizer(cfg)
    t_init, _ = make_optimizer(tcfg)
    j_new, _, jm = jax.jit(j_make_train_step(cfg))(
        jp, j_init(jp), jb, jnp.asarray(0, jnp.int32))
    t_new, _, tm = make_train_step(tcfg)(tp, t_init(tp), tb, 0)
    j_new = jax.device_get(j_new)
    for k in ("loss", "ce_loss", "lr"):
        assert _rel(tm[k], jm[k]) <= LOSS_RTOL, k
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= GRAD_TOL
    _trees_close(t_new, j_new)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b"])
def test_remat_recomputes_the_same_gradients(arch):
    """``remat=True`` (each layer recomputed in the backward through
    torch.utils.checkpoint) gives the gradients of the plain run, bit
    for bit."""
    _, tcfg, _, tp = _models(arch)
    _, tb = _batch(tcfg)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        live = [p.detach().clone().requires_grad_() for p in leaves(tp)]
        tree = unflatten(tp, live)
        loss, _ = TM.train_loss(cfg, tree, tb)
        out.append((loss, torch.autograd.grad(loss, live)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)



def test_prefill_decode_and_serve_step_vs_reference():
    """make_prefill_step, make_decode_step and serve_step against the
    reference's wrappers (the model's prefill and decode_step, as in
    tests/test_torch_model.py's bounds); a distributed context raises."""
    cfg, tcfg, jp, tp = _models("qwen3-0.6b")
    B, T, max_len = 2, 8, 12
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, T))
    jl, jc = JS.make_prefill_step(cfg)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = TS.make_prefill_step(tcfg)(tp, {"tokens": torch.as_tensor(toks)})
    _close(tl, jl)
    _assert_caches_close(tc, jc)
    jc = jax.tree.map(_merge, JM.init_cache(cfg, B, max_len,
                                            dtype=cfg.dtype), jc)
    full = TM.init_cache(tcfg, B, max_len, device="cpu")
    TM.write_cache(full, tc)
    tok = np.argmax(np.asarray(jl), -1)[:, None]
    j_dec, t_dec = JS.make_decode_step(cfg), TS.make_decode_step(tcfg)
    for t, (jf, tf) in enumerate(
            ((j_dec, t_dec), (lambda *a: JS.serve_step(cfg, *a),
                              lambda *a: TS.serve_step(tcfg, *a))), T):
        jl, jc = jf(jp, jc, jnp.asarray(tok, jnp.int32),
                    jnp.full((B,), t, jnp.int32))
        tl, full = tf(tp, full, torch.as_tensor(tok),
                      torch.full((B,), t, dtype=torch.int32))
        _close(tl, jl)
        _assert_caches_close(full, jc)
        tok = np.argmax(np.asarray(jl), -1)[:, None]
    for make in (TS.make_train_step, TS.make_prefill_step,
                 TS.make_decode_step):
        with pytest.raises(NotImplementedError, match="13f"):
            make(tcfg, dist=object())
    with pytest.raises(NotImplementedError, match="13f"):
        TS.serve_step(tcfg, tp, full, torch.as_tensor(tok),
                      torch.full((B,), T + 2, dtype=torch.int32),
                      dist=object())
