"""The residual stream between layers in the reference's ``act_shard``
layout (``distributed.sharding.act_spec``, the reference's
``models/model.py::_constrain_act``) on the CPU: 4 gloo ranks as a 2 x 2
('data', 'model') mesh (tests/_torch_ranks.py), remat on, under each of
``"dmodel"`` (the default: a rank keeps its block of d), ``"seq"`` (its
block of the sequence) and ``"none"`` (whole over 'model'). One rank
group for the whole file.

* ``act_spec`` is the reference's constraint condition for condition
  (its ``_constrain_act`` run on a shape-only mesh, the constraint
  read back): T or d that the axis does not divide, a decode's T of 1
  under ``"seq"`` and a batch the data axes do not divide fall back.
* A sharded train step of reduced qwen3-8b in the bands of
  tests/test_torch_distributed.py: the loss within 2e-4 and every
  parameter within 2e-3 of the reference's step and within 1e-4 of each
  leaf's scale of it; against the port's one-device step the loss,
  ce_loss, grad_norm and lr within 1e-5 relative, every leaf within
  1e-4 of its scale. Prefill of 8 tokens and two greedy decode steps:
  the logits and the whole cache within 1e-5 of one device's scale.
* The residual each layer takes (what ``torch.utils.checkpoint`` is
  handed) is the rank's (b, T, d / 2) under ``"dmodel"``, (b, T / 2,
  d) under ``"seq"``, (b, T, d) under ``"none"``; at T = 15 ``"seq"``
  falls back to whole, as the reference's condition does. What autograd
  saves of them (``saved_tensors_hooks``) is half of ``"none"``'s.
* The whole gradient and the loss of reduced mixtral-8x7b with the
  ``psum_scatter`` MoE combine (its d-block kept, or gathered and laid
  out), of reduced rwkv6-7b (its channel mix's d-block; FSDP) and of
  jamba's Mamba + MLP and attention + MoE layers (Mamba's channels
  tensor-parallel, the ``psum`` combine cut to the block) within 1e-4
  of each leaf's scale and 1e-5 relative of one device's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models.moe import DistContext as JDist
from repro_torch import configs as tconfigs
from repro_torch.core import convert
from repro_torch.core.tree import leaves
from repro_torch.distributed import sharding as shd
from repro_torch.models import model as TM
from repro_torch.models.moe import DistContext
from repro_torch.optim import make_optimizer
from repro_torch.train.steps import _loss_and_grads, make_train_step
from tests._torch_ranks import body_act_shard, run_ranks
from tests._train_ref import OVERRIDES, _batch, _reference, _trees_close

MODES = ["dmodel", "seq", "none"]
STEP = 3
N_LAYERS = 2                     # reduced qwen3-8b's
B_RANK, T, D = 1, 16, 64         # a rank's rows of the B = 2 batch
GRAD_CASES = {
    "mixtral-8x7b psum_scatter": ("mixtral-8x7b", {
        "moe_combine": "psum_scatter", "capacity_factor": 8.0,
        "remat": True}),
    "rwkv6-7b fsdp": ("rwkv6-7b", {"remat": True, "fsdp": True}),
    "jamba-v0.1-52b": ("jamba-v0.1-52b", dict(
        OVERRIDES["jamba-v0.1-52b"], capacity_factor=8.0, remat=True)),
}


def _scale_close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _serve_one(cfg, params, prompt, n_new):
    """prefill, then greedy decode steps, on one device."""
    B, P = prompt.shape
    logits, part = TM.prefill(cfg, params, {"tokens": prompt})
    cache = TM.init_cache(cfg, B, P + n_new, device="cpu")
    TM.write_cache(cache, part)
    outs = [logits]
    for t in range(P, P + n_new):
        logits, cache = TM.decode_step(
            cfg, params, cache, outs[-1].argmax(-1)[:, None],
            torch.full((B,), t, dtype=torch.int32))
        outs.append(logits)
    return outs, cache


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's and the one-device results, and rank 0's
    results of every case under every mode."""
    torch.set_num_threads(1)
    _, tcfg, tp, tb, (_, _, _, (j_new, _, jm)) = _reference("qwen3-8b")
    rcfg = dataclasses.replace(tcfg, remat=True)
    opt_init, _ = make_optimizer(rcfg)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, rcfg.vocab, (4, 8)))
    one = {"ref": (j_new, jm),
           "train": make_train_step(rcfg)(tp, opt_init(tp), tb, STEP),
           "serve": _serve_one(rcfg, tp, prompt, 2), "grads": {}}
    pl = {"modes": MODES, "grads": {},
          "qwen": {"params": tp, "batch": tb, "step": STEP,
                   "prompt": prompt,
                   "batch15": {k: v[:, :15] for k, v in tb.items()}}}
    for name, (arch, over) in GRAD_CASES.items():
        cfg = tconfigs.reduced(tconfigs.get_config(arch), **over)
        params = TM.init_params(cfg, 0, device="cpu")
        batch = _batch(cfg)[1]
        loss, _, grads = _loss_and_grads(cfg, params, batch, None)
        one["grads"][name] = (float(loss), grads)
        pl["grads"][name] = {"arch": arch, "over": over, "params": params,
                             "batch": batch}
    return one, run_ranks(body_act_shard, 4, tmp_path_factory.mktemp("act"),
                          pl)


class _Mesh:
    """A shape-only mesh (the reference's and the port's specs read its
    ``shape``)."""

    def __init__(self, **shape):
        self.shape = shape


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", [{"data": 2, "model": 4},
                                  {"pod": 2, "data": 2, "model": 4}],
                         ids=["2x4", "2x2x4"])
def test_act_spec_is_the_reference_condition(monkeypatch, mode, mesh):
    # the reference's _constrain_act hands its spec to the constraint
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    data = ("pod", "data") if "pod" in mesh else ("data",)
    jdist = JDist(mesh=_Mesh(**mesh), data_axes=data)
    tdist = DistContext(mesh=_Mesh(**mesh), data_axes=data)
    jcfg = jconfigs.reduced(jconfigs.get_config("qwen3-8b"), act_shard=mode)
    tcfg = tconfigs.reduced(tconfigs.get_config("qwen3-8b"), act_shard=mode)
    for shape in [(8, 16, 64), (8, 18, 64), (8, 16, 66), (8, 1, 64),
                  (3, 16, 64), (1, 1, 66)]:
        want = tuple(JM._constrain_act(jcfg, np.zeros(shape, np.float32),
                                       jdist))
        assert shd.act_spec(tcfg, tdist, shape) == want, shape


@pytest.mark.parametrize("mode", MODES)
def test_train_step_in_the_distributed_bands(run, mode):
    one, got = run
    j_new, jm = one["ref"]
    t_new, _, tm = one["train"]
    whole, m = got[mode]["train"]
    assert abs(m["loss"] - float(jm["loss"])) < 2e-4
    d = max(float(np.abs(a.float().numpy() - np.asarray(b, np.float32)).max())
            for a, b in zip(leaves(whole),
                            leaves(convert.params_from_numpy(j_new))))
    assert d < 2e-3, d
    _trees_close(whole, j_new)
    for k in ("loss", "ce_loss", "grad_norm", "lr"):
        assert _rel(m[k], tm[k]) <= 1e-5, k
    for a, b in zip(leaves(whole), leaves(t_new)):
        _scale_close(a, b, 1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_one_device(run, mode):
    one, got = run
    outs, cache = got[mode]["serve"]
    want, want_cache = one["serve"]
    assert len(outs) == len(want) == 3
    for a, b in zip(outs, want):
        _scale_close(a, b, 1e-5)
    for a, b in zip(leaves(cache), leaves(want_cache)):
        assert a.shape == b.shape and a.dtype == b.dtype
        _scale_close(a, b, 1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_residual_between_layers_is_the_block(run, mode):
    _, got = run
    want = {"dmodel": (B_RANK, T, D // 2), "seq": (B_RANK, T // 2, D),
            "none": (B_RANK, T, D)}[mode]
    assert got[mode]["saved"][0] == [want] * N_LAYERS
    # T = 15 does not divide the 2-wide axis: "seq" keeps it whole
    want15 = (B_RANK, 15, D // 2) if mode == "dmodel" else (B_RANK, 15, D)
    assert got[mode]["saved15"][0] == [want15] * N_LAYERS


@pytest.mark.parametrize("mode", MODES)
def test_remat_saves_the_block(run, mode):
    _, got = run
    whole = N_LAYERS * B_RANK * T * D * 4            # float32 residuals
    assert got["none"]["saved"][1] == whole
    assert got[mode]["saved"][1] == (whole if mode == "none" else whole // 2)
    assert got[mode]["saved15"][1] == \
        whole * 15 // T // (2 if mode == "dmodel" else 1)


@pytest.mark.parametrize("case", list(GRAD_CASES))
@pytest.mark.parametrize("mode", MODES)
def test_gradient_matches_one_device(run, mode, case):
    one, got = run
    loss, grads = got[mode]["grads"][case]
    want_loss, want = one["grads"][case]
    assert _rel(loss, want_loss) <= 1e-5
    for g, w in zip(leaves(grads), leaves(want)):
        assert g.shape == w.shape
        _scale_close(g, w, 1e-4)
