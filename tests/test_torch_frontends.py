"""The audio and vision frontends (hubert-xlarge, internvl2-76b) against
the reference, on the CPU.

Both frontends are stubs in the reference: hubert takes precomputed
frame embeddings (``features``, with a loss ``mask`` and frame
``targets``), internvl precomputed patch embeddings (``patches``) put
before the text tokens, its targets padded by the patch count and its
loss masked over the patches. Reduced float32 configs, the reference's
random parameters carried across with ``core.convert.params_from_numpy``,
inputs made with numpy:
  * the shape cells (``SHAPES``, ``cells_for``) and ``input_specs``
    name the reference's cells and batches: names, shapes, dtypes, run
    and skip reason;
  * prefill logits and caches (tests/test_torch_model.py's bounds:
    rtol 1e-4, atol 1e-5 of the leaf's scale), and for internvl the
    decode step after a patch prefill against the full forward and the
    reference's decode;
  * ``train_loss`` and every gradient against ``jax.value_and_grad``
    (tests/_train_ref.py's bounds), with hubert's mask over about half
    the frames; an all-False mask gives a loss of 0 on both sides;
  * one ``make_train_step`` with two microbatches (the split reshapes
    3-D features and the bool mask) against the reference's jitted step;
  * the inputs the reference takes silently or with a bare KeyError
    raise a ValueError here.
"""
import dataclasses

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
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.optim import make_optimizer
from repro_torch.train.steps import make_train_step
from tests._train_ref import (GRAD_TOL, LOSS_RTOL, _leaf_close, _rel,
                              _trees_close, one_thread)  # noqa: F401
from tests.test_torch_model import _assert_caches_close, _close, _merge

HUBERT, INTERNVL = "hubert-xlarge", "internvl2-76b"
B, T = 2, 12


def _models(arch, seed=0, **over):
    cfg = jconfigs.reduced(jconfigs.get_config(arch), **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), **over)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, tcfg, jp, convert.params_from_numpy(jax.device_get(jp))


def span_mask(rng, batch, frames, span=10, share=0.5):
    """HuBERT-style: spans of ``span`` frames from random starts until
    about ``share`` of the frames are masked."""
    mask = np.zeros((batch, frames), bool)
    for b in range(batch):
        while mask[b].mean() < share:
            s = rng.integers(0, frames)
            mask[b, s:s + span] = True
    return mask


def audio_batch(cfg, seed=1, batch=B, frames=T, mask=None):
    """(reference batch, port batch): features, mask, targets."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((batch, frames, cfg.d_model)) \
        .astype(np.float32)
    if mask is None:
        mask = span_mask(rng, batch, frames, span=3)
    tgts = rng.integers(0, cfg.vocab, (batch, frames)).astype(np.int32)
    arrays = {"features": feats, "mask": mask, "targets": tgts}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.as_tensor(v) for k, v in arrays.items()})


def vision_batch(cfg, seed=1, batch=B, n_tokens=T - 4, targets=True):
    """(reference batch, port batch): patches, tokens (and targets)."""
    rng = np.random.default_rng(seed)
    P = cfg.n_frontend_tokens
    arrays = {
        "patches": rng.standard_normal((batch, P, cfg.d_model))
        .astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab, (batch, n_tokens))
        .astype(np.int32)}
    if targets:
        arrays["targets"] = rng.integers(0, cfg.vocab, (batch, n_tokens)) \
            .astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.as_tensor(v) for k, v in arrays.items()})


def _without(batch, *keys):
    return {k: v for k, v in batch.items() if k not in keys}


# -- (a) what a batch is ------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_shape_cells_and_input_specs_match_reference(arch):
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.asdict(tconfigs.SHAPES[name]) == \
            dataclasses.asdict(shape)
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jcells, tcells = jconfigs.cells_for(jcfg), tconfigs.cells_for(tcfg)
    assert [(c.arch, dataclasses.asdict(c.shape), c.run, c.skip_reason)
            for c in tcells] == \
        [(c.arch, dataclasses.asdict(c.shape), c.run, c.skip_reason)
         for c in jcells]
    for name in jconfigs.SHAPES:
        want = jconfigs.input_specs(jcfg, jconfigs.SHAPES[name])
        got = tconfigs.input_specs(tcfg, tconfigs.SHAPES[name])
        assert list(got) == list(want), name
        for k, spec in want.items():
            assert got[k].device.type == "meta", (name, k)
            assert tuple(got[k].shape) == spec.shape, (name, k)
            assert str(got[k].dtype).removeprefix("torch.") == \
                jnp.dtype(spec.dtype).name, (name, k)


# -- (b) hubert's prefill -----------------------------------------------------

def test_hubert_prefill_vs_reference():
    cfg, tcfg, jp, tp = _models(HUBERT)
    jb, tb = audio_batch(cfg)
    jb, tb = _without(jb, "mask", "targets"), _without(tb, "mask", "targets")
    jl, jc = JM.prefill(cfg, jp, jb)
    tl, tc = TM.prefill(tcfg, tp, tb, kernel_fns=ops.model_kernel_fns())
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _close(tl, jl)
    _assert_caches_close(tc, jc)


# -- (c) hubert's loss and gradients ----------------------------------------

def _loss_and_grads(tcfg, tp, tb):
    live = [p.detach().clone().requires_grad_() for p in leaves(tp)]
    loss, metrics = TM.train_loss(tcfg, unflatten(tp, live), tb,
                                  kernel_fns=ops.model_kernel_fns())
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), metrics, [
        torch.zeros_like(p) if g is None else g for g, p in zip(grads, live)]


def _hold_loss_and_grads(cfg, tcfg, jp, tp, jb, tb):
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda q: JM.train_loss(cfg, q, jb), has_aux=True))(jp)
    tl, tm, grads = _loss_and_grads(tcfg, tp, tb)
    assert tl.dtype == torch.float32 and tl.dim() == 0
    assert _rel(tl, jl) <= LOSS_RTOL
    assert _rel(tm["ce_loss"].detach(), jm["ce_loss"]) <= LOSS_RTOL
    want = convert.params_from_numpy(jax.device_get(jg))
    for (path, w), g in zip(paths(want), grads):
        assert g.shape == w.shape, path
        _leaf_close(g, w.numpy())
    return tl, grads


def test_hubert_train_loss_and_grads_vs_reference():
    cfg, tcfg, jp, tp = _models(HUBERT)
    jb, tb = audio_batch(cfg)
    share = float(tb["mask"].float().mean())
    assert 0.4 <= share <= 0.75, share
    tl, grads = _hold_loss_and_grads(cfg, tcfg, jp, tp, jb, tb)
    # the embedding is not on an audio path: its gradient is 0 there too
    assert not bool(grads[[p for p, _ in paths(tp)].index(("embed",))].any())
    # the mask selects frames: the unmasked loss is another number
    full, _, _ = _loss_and_grads(tcfg, tp, _without(tb, "mask"))
    assert abs(float(full) - float(tl)) > 1e-4


def test_hubert_all_false_mask_gives_zero_loss():
    cfg, tcfg, jp, tp = _models(HUBERT)
    jb, tb = audio_batch(cfg, mask=np.zeros((B, T), bool))
    jl, _ = JM.train_loss(cfg, jp, jb)
    tl, _, grads = _loss_and_grads(tcfg, tp, tb)
    assert float(jl) == 0.0 and float(tl) == 0.0
    assert not any(bool(g.any()) for g in grads)


# -- (d) internvl's prefill and decode ---------------------------------------

def test_internvl_prefill_and_decode_vs_reference():
    cfg, tcfg, jp, tp = _models(INTERNVL)
    P = cfg.n_frontend_tokens
    jb, tb = vision_batch(cfg, targets=False)
    jl, jc = JM.prefill(cfg, jp, jb)
    tl, tc = TM.prefill(tcfg, tp, tb, kernel_fns=ops.model_kernel_fns())
    _close(tl, jl)
    _assert_caches_close(tc, jc)
    assert tc["pos_offset"].tolist() == [T] * B
    assert tc["layers"][0]["k"].shape[1] == T == P + tb["tokens"].shape[1]

    max_len = T + 3
    jc = jax.tree.map(_merge, JM.init_cache(cfg, B, max_len,
                                            dtype=cfg.dtype), jc)
    cache = TM.init_cache(tcfg, B, max_len, device="cpu")
    TM.write_cache(cache, tc)
    tok = np.argmax(np.asarray(jl), -1)[:, None]
    for t in range(T, T + 3):
        jl, jc = JM.decode_step(cfg, jp, jc, jnp.asarray(tok, jnp.int32),
                                jnp.full((B,), t, jnp.int32))
        tl, cache = TM.decode_step(tcfg, tp, cache, torch.as_tensor(tok),
                                   torch.full((B,), t, dtype=torch.int32),
                                   kernel_fns=ops.model_kernel_fns())
        _close(tl, jl)
        _assert_caches_close(cache, jc)
        tok = np.argmax(np.asarray(jl), -1)[:, None]


def test_internvl_decode_after_patches_matches_full_forward():
    """tests/test_decode_consistency.py's vision case on the port: the
    decode step after a prefill of the patches and all but the last
    token gives the full forward's logits."""
    _, tcfg, _, tp = _models(INTERNVL, seed=1, capacity_factor=8.0)
    _, tb = vision_batch(tcfg, seed=2, targets=False)
    full, _ = TM.prefill(tcfg, tp, tb)
    _, pre = TM.prefill(tcfg, tp, dict(tb, tokens=tb["tokens"][:, :-1]))
    cache = TM.init_cache(tcfg, B, T, device="cpu")
    TM.write_cache(cache, pre)
    dec, new = TM.decode_step(tcfg, tp, cache, tb["tokens"][:, -1:],
                              torch.full((B,), T - 1, dtype=torch.int32))
    assert float((dec - full).abs().max()) < 3e-3
    for a, b in zip(cache["layers"], new["layers"]):
        assert {k: (v.shape, v.dtype) for k, v in a.items()} == \
            {k: (v.shape, v.dtype) for k, v in b.items()}


def test_generate_with_patches_vs_reference():
    """``launch.serve.generate`` with patches: the greedy tokens of the
    reference's prefill and decode steps over a cache of patches +
    prompt + new positions."""
    cfg, tcfg, jp, tp = _models(INTERNVL, seed=2)
    jb, tb = vision_batch(cfg, seed=4, targets=False)
    gen = 4
    got = serve.generate(tcfg, tp, tb["tokens"], gen,
                         kernel_fns=ops.model_kernel_fns(),
                         patches=tb["patches"])
    jl, jc = JM.prefill(cfg, jp, jb)
    jc = jax.tree.map(_merge, JM.init_cache(cfg, B, T + gen,
                                            dtype=cfg.dtype), jc)
    tok = jnp.argmax(jl, -1)[:, None]
    want = [tok]
    for t in range(T, T + gen - 1):
        jl, jc = JM.decode_step(cfg, jp, jc, tok, jnp.full((B,), t,
                                                           jnp.int32))
        tok = jnp.argmax(jl, -1)[:, None]
        want.append(tok)
    assert got["tokens"].tolist() == np.concatenate(want, 1).tolist()


# -- (e) internvl's loss and gradients --------------------------------------

def test_internvl_train_loss_and_grads_vs_reference():
    cfg, tcfg, jp, tp = _models(INTERNVL)
    jb, tb = vision_batch(cfg)
    _hold_loss_and_grads(cfg, tcfg, jp, tp, jb, tb)


# -- (f) a train step of two microbatches -----------------------------------

@pytest.mark.parametrize("arch", [HUBERT, INTERNVL])
def test_microbatched_train_step_vs_reference(arch):
    cfg, tcfg, jp, tp = _models(arch, microbatches=2)
    make = audio_batch if arch == HUBERT else vision_batch
    jb, tb = make(cfg, seed=3, batch=4)
    j_init, _ = j_make_optimizer(cfg)
    t_init, _ = make_optimizer(tcfg)
    j_new, _, jm = jax.jit(j_make_train_step(cfg))(
        jp, j_init(jp), jb, jnp.asarray(2, jnp.int32))
    t_new, t_opt, tm = make_train_step(
        tcfg, kernel_fns=ops.model_kernel_fns())(tp, t_init(tp), tb, 2)
    for k in ("loss", "ce_loss", "lr"):
        assert _rel(tm[k], jm[k]) <= LOSS_RTOL, k
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= GRAD_TOL
    assert int(t_opt["step"]) == 1
    _trees_close(t_new, jax.device_get(j_new))


# -- (g) what the reference takes silently ----------------------------------

def test_frontend_inputs_are_checked():
    _, hcfg, _, hp = _models(HUBERT)
    _, hb = audio_batch(hcfg)
    with pytest.raises(ValueError, match="'features'"):
        TM.prefill(hcfg, hp, {"tokens": torch.zeros((B, T),
                                                     dtype=torch.int32)})
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(ValueError, match="input_specs"):
            TM.train_loss(hcfg, hp, dict(hb, features=hb["features"]
                                         .to(dtype)))
    _, vcfg, _, vp = _models(INTERNVL)
    _, vb = vision_batch(vcfg)
    P = vcfg.n_frontend_tokens
    for n in (P - 1, P + 1):
        patches = torch.zeros((B, n, vcfg.d_model))
        with pytest.raises(ValueError, match="n_frontend_tokens"):
            TM.train_loss(vcfg, vp, dict(vb, patches=patches))
        with pytest.raises(ValueError, match="n_frontend_tokens"):
            TM.prefill(vcfg, vp, dict(_without(vb, "targets"),
                                      patches=patches))
