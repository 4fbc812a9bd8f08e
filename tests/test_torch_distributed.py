"""The port's distributed layer on the CPU: 4 gloo ranks as a 2 x 2
('data', 'model') mesh (tests/_torch_ranks.py), each case against the
JAX reference and against the port's one-device result on the same
numpy inputs (the reference's own multi-device tests,
tests/test_distributed.py and tests/test_perf_paths.py, hold its
sharded runs to its single-device ones; here the reference runs on one
device in this process). One rank group for the whole file. The model
keeps its residual between layers as the reference's default
``act_shard="dmodel"`` lays it out: each rank its block of d
(tests/test_torch_act_shard.py holds every ``act_shard``).

* The sharded train step (reduced qwen3-8b, 4 heads over 2 kv heads:
  tensor parallelism over 'model', the batch over 'data') from the
  reference's parameters: the loss within 2e-4 and every parameter
  within 2e-3 of the reference's step (its bounds), and each leaf within
  1e-4 of its scale; against the port's one-device step the loss and
  grad_norm within 1e-5 relative, every leaf within 1e-4 of its scale.
  The same for one ZeRO-2 step (moments sharded over 'data'), and for
  one FSDP step (``fsdp=True``), whose gradient blocks are also held
  within 1e-4 of each leaf's scale of the reference's and the one-device
  gradient; one adafactor step on FSDP x TP blocks against one device's
  (parameters and the gathered state, 1e-4).
* ``moe_apply_dist`` against ``moe_apply_pure`` (2e-4, aux 1e-4): reduced
  mixtral in ``ep`` mode, reduced jamba with the ``psum_scatter``
  combine, and mixtral in ``tp`` mode with each combine.
* ``gqa_decode_sp`` (``decode_sp``, the cache sequence-sharded over
  'model'): logits within 3e-3 of the reference's full-prefill logits
  (its bound) and 1e-5 of the one-device decode's scale; the cache's
  local leaves keep their shapes and dtypes, the whole new cache equals
  the one-device one; one step's collective bytes are the same at two
  cache lengths (O(B H d_head) a layer, not O(cache)): a layer's pmax
  and two psums of the partial softmax, its MLP's partial output
  reduce-scattered into the residual's block.
* prefill and two decode steps on the mesh (``decode_sp`` off: the
  cache's kv heads over 'model') against one device (1e-5).
* ``pipeline_apply`` on a 4-rank 'stage' mesh against the serial loop
  (1e-5).
* ``Trainer(dist=...)``: 2 steps, a checkpoint (gathered, rank 0
  writes), a restart resuming at step 2 to step 4: the losses within
  1e-5 relative of the one-device Trainer's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.core import convert
from repro_torch.core.tree import leaves, paths
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.optim import make_optimizer
from repro_torch.train.steps import _loss_and_grads, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from tests._torch_ranks import body_2x2, run_ranks
from tests._train_ref import _reference, _trees_close

MOE_CASES = {
    "mixtral ep psum": ("mixtral-8x7b", {}),
    "jamba ep psum_scatter": ("jamba-v0.1-52b",
                              {"moe_combine": "psum_scatter"}),
    "mixtral tp psum": ("mixtral-8x7b", {"expert_parallel": False}),
    "mixtral tp psum_scatter": ("mixtral-8x7b", {"expert_parallel": False,
                                                 "moe_combine":
                                                 "psum_scatter"}),
}
DECODE_B, DECODE_T = 4, 12
STEP = 3


def _t(a):
    return torch.as_tensor(np.array(a))


def _scale_close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, the reference's and the one-device results, and rank 0's
    results of every case."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("ranks")
    ref = {}
    # the train step: the reference's reduced qwen3-8b, batch and step
    cfg, tcfg, tp, tb, (_, _, jg, (j_new, _, jm)) = _reference("qwen3-8b")
    ref["train"] = (j_new, jm)
    opt_init, _ = make_optimizer(tcfg)
    one = make_train_step(tcfg, kernel_fns=ops.model_kernel_fns())(
        tp, opt_init(tp), tb, STEP)
    ref["train_one"] = one
    ref["grads_ref"] = convert.params_from_numpy(jg)
    ref["grads_one"] = _loss_and_grads(tcfg, tp, tb, None)[2]
    acfg = dataclasses.replace(tcfg, optimizer="adafactor")
    af_init, _ = make_optimizer(acfg)
    ref["adafactor_one"] = make_train_step(acfg)(tp, af_init(tp), tb, STEP)
    pl = {"tmp": str(tmp),
          "train": {"over": {}, "params": tp, "batch": tb, "step": STEP}}
    # MoE
    pl["moe"] = {}
    for name, (arch, over) in MOE_CASES.items():
        over = dict(over, capacity_factor=8.0)
        jcfg = jconfigs.reduced(jconfigs.get_config(arch), **over)
        tcfg_m = tconfigs.reduced(tconfigs.get_config(arch), **over)
        p = jax.device_get(jmoe.moe_init(jax.random.PRNGKey(0), jcfg,
                                         jnp.float32))
        x = np.random.default_rng(2).standard_normal(
            (4, 8, jcfg.d_model)).astype(np.float32)
        y, aux = jmoe.moe_apply_pure(p, jcfg, jnp.asarray(x))
        tpm = {k: _t(v) for k, v in p.items()}
        ty, taux = tmoe.moe_apply_pure(tpm, tcfg_m, torch.as_tensor(x))
        ref[name] = (np.asarray(y), float(aux), ty, float(taux))
        pl["moe"][name] = {"arch": arch, "over": over, "p": tpm,
                           "x": torch.as_tensor(x)}
    # decode: the reference test's run, its full prefill as the truth
    dcfg = jconfigs.reduced(jconfigs.get_config("qwen3-8b"))
    dtcfg = tconfigs.reduced(tconfigs.get_config("qwen3-8b"))
    jp = JM.init_params(dcfg, jax.random.PRNGKey(0))
    dp = convert.params_from_numpy(jax.device_get(jp))
    toks = np.random.default_rng(3).integers(
        0, dcfg.vocab, (DECODE_B, DECODE_T)).astype(np.int32)
    full_logits, _ = JM.prefill(dcfg, jp, {"tokens": jnp.asarray(toks)})
    ref["decode_full"] = np.asarray(full_logits)
    _, part = TM.prefill(dtcfg, dp, {"tokens": torch.as_tensor(
        toks[:, :-1])})
    cache = TM.init_cache(dtcfg, DECODE_B, DECODE_T, device="cpu")
    TM.write_cache(cache, part)
    token = torch.as_tensor(toks[:, -1:])
    pos = torch.full((DECODE_B,), DECODE_T - 1, dtype=torch.int32)
    pl["decode"] = {"params": dp, "cache": cache, "token": token,
                    "pos": pos, "prompt": torch.as_tensor(toks[:, :8])}
    twin = {"pos_offset": cache["pos_offset"].clone(),
            "layers": [{k: v.clone() for k, v in c.items()}
                       for c in cache["layers"]]}
    ref["decode_one"] = TM.decode_step(dtcfg, dp, twin, token, pos)
    # serving on one device: prefill of 8 tokens, two greedy steps
    logits, c8 = TM.prefill(dtcfg, dp, {"tokens": pl["decode"]["prompt"]})
    full = TM.init_cache(dtcfg, DECODE_B, 10, device="cpu")
    TM.write_cache(full, c8)
    outs = [logits]
    for t in (8, 9):
        logits, full = TM.decode_step(
            dtcfg, dp, full, outs[-1].argmax(-1)[:, None],
            torch.full((DECODE_B,), t, dtype=torch.int32))
        outs.append(logits)
    ref["serve"] = (outs, full)
    # the pipeline's serial loop
    rng = np.random.default_rng(4)
    Ws = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    want = jnp.asarray(x)
    for s in range(4):
        want = jnp.tanh(want @ jnp.asarray(Ws[s]))
    ref["pipeline"] = np.asarray(want)
    pl["pipeline"] = {"Ws": torch.as_tensor(Ws), "x": torch.as_tensor(x)}
    # the trainer on one device
    tcfg06 = tconfigs.reduced(tconfigs.get_config("qwen3-0.6b"))
    pl["data"] = DataConfig(vocab=tcfg06.vocab, seq_len=16, global_batch=4)
    t = Trainer(cfg=tcfg06, tcfg=TrainerConfig(
        ckpt_dir=str(tmp / "one"), total_steps=4, ckpt_every=0, seed=0),
        data=pl["data"], device="cpu")
    t.run()
    ref["trainer"] = t.losses()
    return ref, run_ranks(body_2x2, 4, tmp, pl)


def test_sharded_train_step_matches_single_device(run):
    ref, got = run
    j_new, jm = ref["train"]
    t_new, _, tm = ref["train_one"]
    whole, m = got["train"]
    assert abs(m["loss"] - float(jm["loss"])) < 2e-4
    d = max(float(np.abs(a.float().numpy() - np.asarray(b, np.float32)).max())
            for a, b in zip(leaves(whole), leaves(
                convert.params_from_numpy(j_new))))
    assert d < 2e-3, d
    _trees_close(whole, j_new)
    for k in ("loss", "ce_loss", "grad_norm", "lr"):
        assert _rel(m[k], tm[k]) <= 1e-5, k
    for (path, a), b in zip(paths(whole), leaves(t_new)):
        _scale_close(a, b, 1e-4)


def test_zero2_step_matches_single_device(run):
    ref, got = run
    j_new, jm = ref["train"]
    t_new, _, tm = ref["train_one"]
    whole, m = got["zero2"]
    assert abs(m["loss"] - float(jm["loss"])) < 2e-4
    _trees_close(whole, j_new)
    assert _rel(m["grad_norm"], tm["grad_norm"]) <= 1e-5
    for a, b in zip(leaves(whole), leaves(t_new)):
        _scale_close(a, b, 1e-4)


def test_fsdp_train_step_matches_single_device(run):
    """FSDP (``fsdp=True``: the matrices also cut over 'data', gathered
    at use, their gradients reduce-scattered back to blocks): every
    block of the gradient within 1e-4 of its leaf's scale of the
    reference's and of the one-device gradient, and the step held as
    the TP step is."""
    ref, got = run
    j_new, jm = ref["train"]
    t_new, _, tm = ref["train_one"]
    whole, m, grads = got["fsdp"]
    for g, jg, tg in zip(leaves(grads), leaves(ref["grads_ref"]),
                         leaves(ref["grads_one"])):
        _scale_close(g, jg, 1e-4)
        _scale_close(g, tg, 1e-4)
    assert abs(m["loss"] - float(jm["loss"])) < 2e-4
    _trees_close(whole, j_new)
    for k in ("loss", "grad_norm"):
        assert _rel(m[k], tm[k]) <= 1e-5, k
    for a, b in zip(leaves(whole), leaves(t_new)):
        _scale_close(a, b, 1e-4)


def test_adafactor_step_on_the_mesh_matches_single_device(run):
    """Adafactor on FSDP x TP blocks (its factored statistics' means
    and RMS clip summed over the ranks): the new parameters and the
    whole gathered state within 1e-4 of each leaf's scale of the
    one-device step's, the state in the same layout."""
    ref, got = run
    t_new, t_opt, tm = ref["adafactor_one"]
    whole, m, opt = got["adafactor"]
    assert _rel(m["loss"], tm["loss"]) <= 1e-5
    assert _rel(m["grad_norm"], tm["grad_norm"]) <= 1e-5
    for a, b in zip(leaves(whole), leaves(t_new)):
        _scale_close(a, b, 1e-4)
    assert [p for p, _ in paths(opt)] == [p for p, _ in paths(t_opt)]
    for a, b in zip(leaves(opt), leaves(t_opt)):
        assert a.shape == b.shape
        _scale_close(a, b, 1e-4)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_dist_matches_pure(run, case):
    ref, got = run
    jy, jaux, ty, taux = ref[case]
    y, aux, mode = got["moe"][case]
    assert mode == ("tp" if "tp" in case else "ep")
    assert float(np.abs(y.numpy() - jy).max()) < 2e-4
    assert float((y - ty).abs().max()) < 2e-4
    assert abs(aux - jaux) < 1e-4 and abs(aux - taux) < 1e-4


def test_decode_sp_matches_plain_decode(run):
    ref, got = run
    logits, cache, kept = got["decode_sp"]
    one_logits, one_cache = ref["decode_one"]
    assert float(np.abs(logits.numpy() - ref["decode_full"]).max()) < 3e-3
    _scale_close(logits, one_logits, 1e-5)
    assert kept
    for a, b in zip(leaves(cache), leaves(one_cache)):
        assert a.shape == b.shape and a.dtype == b.dtype
        _scale_close(a, b, 1e-6)


def test_decode_sp_collectives_do_not_grow_with_the_cache(run):
    _, got = run
    short, long = got["decode_bytes"]
    assert short == long
    # the combine: a pmax and two psums over 'model' a layer; the MLP's
    # partial output reduce-scattered into the residual's block of d
    assert short[("pmax", "model")][0] == 2
    assert short[("psum", "model")][0] == 2 * 2
    assert short[("psum_scatter", "model")][0] == 2


def test_prefill_and_decode_on_the_mesh_match_one_device(run):
    ref, got = run
    outs, cache = got["serve"]
    want, want_cache = ref["serve"]
    assert len(outs) == len(want) == 3
    for a, b in zip(outs, want):
        _scale_close(a, b, 1e-5)
    for a, b in zip(leaves(cache), leaves(want_cache)):
        assert a.shape == b.shape and a.dtype == b.dtype
        _scale_close(a, b, 1e-5)


def test_pipeline_parallel_executor(run):
    ref, got = run
    np.testing.assert_allclose(got["pipeline"].numpy(), ref["pipeline"],
                               atol=1e-5)


def test_trainer_on_the_mesh_resumes_as_one_device(run):
    ref, got = run
    assert len(got["trainer"]) == len(ref["trainer"]) == 4
    for a, b in zip(got["trainer"], ref["trainer"]):
        assert _rel(a, b) <= 1e-5, (got["trainer"], ref["trainer"])
