"""The sharded layouts of the port's distributed layer on the CPU: 4
gloo ranks as a 2 x 2 ('data', 'model') mesh (tests/_torch_ranks.py),
each case against the JAX reference and against the port's one-device
result on the same numpy inputs, in the bands of
tests/test_torch_distributed.py. One rank group for the whole file.

* The vocab-parallel head (the head's vocab over 'model', each rank's
  float32 logits (b, T, V / m), ``layers.vocab_parallel_nll``): a train
  step of reduced qwen3-8b (untied) and of qwen3-0.6b (tied: the table's
  lookup vocab-parallel too; FSDP), and RWKV and Mamba tensor-parallel
  over 'model' (reduced rwkv6-7b, FSDP; jamba-v0.1-52b's Mamba + MLP and
  attention + MoE layers): the loss within 2e-4 and every parameter
  within 2e-3 of the reference's step; against the port's one-device
  step the loss and grad_norm within 1e-5 relative, every parameter
  within 1e-4 of its leaf's scale; the whole gradient gathered from the
  ranks' blocks within 1e-4 of each leaf's scale of the reference's and
  the one-device gradient.
* prefill and 4 decode steps on the cache layout of
  ``sharding.cache_specs``: reduced granite-34b (n_kv 1: the sequence
  over 'model'), qwen3-8b (n_kv 2: the rank's kv heads), mixtral-8x7b
  with n_kv 1 and a window of 8 (a rolling cache, prefilled past its
  window and decoded further), qwen3-8b and granite-34b at B = 1 (the
  sequence over 'data', and over 'data' x 'model'), minicpm3-4b (MLA's
  latent rows over 'model'), rwkv6-7b and jamba (their heads' and
  channels' states): each step's logits within 1e-5 of the one-device
  decode's scale and the last within 3e-3 of the reference's prefill of
  every token (test_decode_sp_matches_plain_decode's bands); each
  rank's prefill cache blocks equal, within 1e-5 of each leaf's scale,
  the blocks ``cache_specs`` lays out of the one-device prefill's cache;
  the blocks keep their shapes through the decode, the whole final
  cache equals the one-device one (1e-6 of scale), and a decode step's
  collectives (calls and bytes) are the same on a cache twice as long:
  no cache is gathered.
"""
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
from repro_torch.core.tree import leaves, paths, tree_map
from repro_torch.models import model as TM
from repro_torch.optim import make_optimizer
from repro_torch.train.steps import _loss_and_grads, make_train_step
from tests._torch_ranks import body_tp, run_ranks
from tests._train_ref import OVERRIDES, _batch

#: no token dropped on either side: a rank's MoE capacity counts its own
#: tokens
MOE = {"capacity_factor": 8.0}
JAMBA = dict(OVERRIDES["jamba-v0.1-52b"], **MOE)
TRAIN_CASES = {
    "qwen3-8b untied head": ("qwen3-8b", {}),
    "qwen3-0.6b tied table fsdp": ("qwen3-0.6b", {"fsdp": True}),
    "rwkv6-7b fsdp": ("rwkv6-7b", {"fsdp": True}),
    "jamba-v0.1-52b": ("jamba-v0.1-52b", JAMBA),
}
#: name -> (arch, overrides, B, prompt T, cache length); 4 decode steps
N_NEW = 4
DECODE_CASES = {
    "granite-34b sequence": ("granite-34b", {}, 4, 8, 12),
    "qwen3-8b heads": ("qwen3-8b", {}, 4, 8, 12),
    "mixtral-8x7b window": ("mixtral-8x7b", dict(MOE, n_kv=1,
                                                 swa_window=8), 4, 10, 10),
    "qwen3-8b B1": ("qwen3-8b", {}, 1, 8, 12),
    "granite-34b B1": ("granite-34b", {}, 1, 8, 12),
    "minicpm3-4b latent": ("minicpm3-4b", {}, 4, 8, 12),
    "rwkv6-7b": ("rwkv6-7b", {}, 4, 8, 12),
    "jamba-v0.1-52b": ("jamba-v0.1-52b", JAMBA, 4, 8, 12),
}
STEP = 3
ADAMW_B1 = 0.9           # repro.optim.adamw's default


def _scale_close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _reference_layout(tcfg, tp):
    """The port's parameters in the reference's layout (numpy): the
    ``prefix<i>`` layers, then ``stack["sub<j>"]`` with a leading n_scan
    axis (``core.convert.params_from_numpy``'s inverse)."""
    n_prefix, n_scan, period = TM.stack_plan(tcfg)
    layers = tp["layers"]
    out = {k: tp[k].numpy() for k in ("embed", "final_norm", "head")
           if k in tp}
    for i in range(n_prefix):
        out[f"prefix{i}"] = tree_map(lambda t: t.numpy(), layers[i])
    out["stack"] = {f"sub{j}": tree_map(
        lambda *ts: np.stack([t.numpy() for t in ts]),
        *[layers[n_prefix + s * period + j] for s in range(n_scan)])
        for j in range(period)}
    return jax.tree.map(jnp.asarray, out)


def _configs(arch, over):
    return (jconfigs.reduced(jconfigs.get_config(arch), **over),
            tconfigs.reduced(tconfigs.get_config(arch), **over))


@functools.lru_cache(maxsize=None)
def _params(arch, over):
    """The port's parameters of a reduced config (seed 0)."""
    return TM.init_params(_configs(arch, dict(over))[1], 0, device="cpu")


def _train_inputs(arch, over):
    """The port's one-device step and gradients, and the payload of the
    rank group."""
    cfg, tcfg = _configs(arch, over)
    tp = _params(arch, tuple(over.items()))
    _, tb = _batch(cfg)
    t_init, _ = make_optimizer(tcfg)
    one = {"step": make_train_step(tcfg)(tp, t_init(tp), tb, STEP),
           "grads": _loss_and_grads(tcfg, tp, tb, None)[2]}
    return one, {"arch": arch, "over": over, "params": tp, "batch": tb,
                 "step": STEP}


@functools.lru_cache(maxsize=None)
def _train_reference(case):
    """The reference's train step on the case's batch (one jitted
    program): (its loss, its new parameters, its gradient: AdamW's first
    moment after one step from zero moments is (1 - b1) g)."""
    arch, over = TRAIN_CASES[case]
    cfg, tcfg = _configs(arch, over)
    jp = _reference_layout(tcfg, _params(arch, tuple(over.items())))
    jb, _ = _batch(cfg)
    j_init, _ = j_make_optimizer(cfg)
    j_new, j_opt, jm = jax.device_get(jax.jit(j_make_train_step(cfg))(
        jp, j_init(jp), jb, jnp.asarray(STEP, jnp.int32)))
    grads = jax.tree.map(lambda m: np.asarray(m) / (1 - ADAMW_B1),
                         j_opt["m"])
    return (float(jm["loss"]), convert.params_from_numpy(j_new),
            convert.params_from_numpy(grads))


def _tokens(arch, over, B, T):
    cfg = _configs(arch, over)[0]
    return np.random.default_rng(5).integers(
        0, cfg.vocab, (B, T + N_NEW)).astype(np.int32)


def _decode_inputs(arch, over, B, T, cache_len):
    """The port's one-device prefill cache, decode logits and final
    cache, and the payload of the rank group."""
    tcfg = _configs(arch, over)[1]
    tp = _params(arch, tuple(over.items()))
    tokens = torch.as_tensor(_tokens(arch, over, B, T))
    logits, cache = TM.prefill(tcfg, tp, {"tokens": tokens[:, :T]})
    prefill_cache = _clone(cache)
    if cache_len != T:
        whole = TM.init_cache(tcfg, B, cache_len, device="cpu")
        TM.write_cache(whole, cache)
        cache = whole
    outs = [logits]
    for t in range(T, T + N_NEW):
        logits, cache = TM.decode_step(tcfg, tp, cache, tokens[:, t:t + 1],
                                       torch.full((B,), t,
                                                  dtype=torch.int32))
        outs.append(logits)
    return {"outs": outs, "cache": cache}, {
        "arch": arch, "over": over, "params": tp, "tokens": tokens, "T": T,
        "cache_len": cache_len, "prefill_cache": prefill_cache}


def _decode_reference(case):
    """The last logits of the reference's prefill of every token."""
    arch, over, B, T, _ = DECODE_CASES[case]
    cfg, tcfg = _configs(arch, over)
    jp = _reference_layout(tcfg, _params(arch, tuple(over.items())))
    full, _ = JM.prefill(cfg, jp, {"tokens": jnp.asarray(
        _tokens(arch, over, B, T))})
    return np.asarray(full)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The one-device results and rank 0's results of every case."""
    torch.set_num_threads(1)
    one, pl = {"train": {}, "decode": {}}, {"train": {}, "decode": {}}
    for name, (arch, over) in TRAIN_CASES.items():
        one["train"][name], pl["train"][name] = _train_inputs(arch, over)
    for name, case in DECODE_CASES.items():
        one["decode"][name], pl["decode"][name] = _decode_inputs(*case)
    return one, run_ranks(body_tp, 4, tmp_path_factory.mktemp("tp"), pl)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_sharded_train_step_matches_reference_and_one_device(run, case):
    one, got = run
    loss, j_new, jg = _train_reference(case)
    whole, m, grads = got["train"][case]
    t_new, _, tm = one["train"][case]["step"]
    assert abs(m["loss"] - loss) < 2e-4
    d = max(float((a - b).abs().max()) for a, b in
            zip(leaves(whole), leaves(j_new)))
    assert d < 2e-3, d
    for k in ("loss", "ce_loss", "grad_norm"):
        assert _rel(m[k], tm[k]) <= 1e-5, k
    for a, b in zip(leaves(whole), leaves(t_new)):
        _scale_close(a, b, 1e-4)
    assert [p for p, _ in paths(grads)] == [p for p, _ in paths(jg)]
    for g, want_ref, want_one in zip(leaves(grads), leaves(jg),
                                     leaves(one["train"][case]["grads"])):
        assert g.shape == want_ref.shape
        _scale_close(g, want_ref, 1e-4)
        _scale_close(g, want_one, 1e-4)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_prefill_and_decode_on_the_cache_layout(run, case):
    one, got = run
    r = one["decode"][case]
    outs, cache, layout, kept, counts = got["decode"][case]
    assert len(outs) == len(r["outs"]) == N_NEW + 1
    for a, b in zip(outs, r["outs"]):
        _scale_close(a, b, 1e-5)
    full = _decode_reference(case)
    assert float(np.abs(outs[-1].numpy() - full).max()) < 3e-3
    assert layout <= 1e-5, layout
    assert kept
    for a, b in zip(leaves(cache), leaves(r["cache"])):
        assert a.shape == b.shape and a.dtype == b.dtype
        _scale_close(a, b, 1e-6)
    # no collective of a decode step grows with the cache
    last, longer = counts
    assert last == longer
