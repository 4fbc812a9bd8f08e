"""Rank groups on the CPU for the distributed tests of the port
(tests/test_torch_distributed.py, tests/test_torch_dist_elastic.py,
tests/test_torch_dist_tp.py, tests/test_torch_act_shard.py):
``torch.multiprocessing.spawn`` starts the ranks, a ``file://`` store
under the test's temporary directory joins them over gloo (the
counterpart of tests/_subproc.py's fake devices). The rank bodies live
here, with no JAX import: the test process computes the reference and
the one-device results, hands the inputs over in a file and compares
what rank 0 hands back.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp


def run_ranks(body, n: int, tmp: Path, payload):
    """``body(rank, payload)`` on ``n`` gloo ranks; rank 0's return."""
    tmp = Path(tmp)
    torch.save(payload, tmp / "in.pt")
    mp.spawn(_rank_main, args=(body, n, str(tmp)), nprocs=n, join=True)
    return torch.load(tmp / "out.pt", weights_only=False)


def _rank_main(rank, body, n, tmp):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                             rank=rank, world_size=n)
    payload = torch.load(f"{tmp}/in.pt", weights_only=False)
    out = body(rank, payload)
    if rank == 0:
        torch.save(out, f"{tmp}/out.pt")
    tdist.barrier()
    tdist.destroy_process_group()


def _cfg(arch, **over):
    from repro_torch import configs
    return dataclasses.replace(configs.reduced(configs.get_config(arch)),
                               **over)


def _dist(data=2, model=2):
    from repro_torch.launch.mesh import dist_for, make_test_mesh
    return dist_for(make_test_mesh(data, model))


def _train(cfg, dist, params, batch, step):
    """One sharded step from whole ``params``: (whole new params,
    metrics, the rank's new blocks)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.steps import init_opt_state, make_train_step
    specs = shd.param_specs(cfg, dist)[0]
    blocks = shd.shard_tree(params, specs, dist)
    new, opt, m = make_train_step(cfg, dist)(
        blocks, init_opt_state(cfg, blocks, dist), batch, step)
    return (shd.unshard_tree(new, specs, dist),
            {k: float(v) for k, v in m.items()}, new, opt)


def _grads(cfg, dist, params, batch):
    """The whole gradient of ``train_loss``, from the rank's blocks'
    gradients (gathered back)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.steps import _loss_and_grads
    specs = shd.param_specs(cfg, dist)[0]
    grads = _loss_and_grads(cfg, shd.shard_tree(params, specs, dist), batch,
                            None, dist)[2]
    return shd.unshard_tree(grads, specs, dist)


def _moe_case(cfg, dist, p, x):
    """moe_apply_dist on the rank's blocks of p and rows of x; the
    whole output gathered back."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe
    specs = moe.moe_param_specs(cfg, dist)
    blocks = {k: shd.block(v, specs[k], dist) for k, v in p.items()}
    data = (C.spec_entry(dist.data_axes),)
    y, aux = moe.moe_apply_dist(blocks, cfg, shd.block(x, data, dist), dist)
    if y.shape[-1] != x.shape[-1]:                  # psum_scatter's layout
        y = shd.unblock(y, (None, None, "model"), dist)
    return shd.unblock(y, data, dist), float(aux), moe.ep_mode(cfg, dist)


def _decode_sp(cfg, dist, params, cache, token, pos):
    """One decode_sp step on the rank's blocks: (logits, the whole new
    cache, whether every local leaf kept its shape and dtype)."""
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    specs = shd.param_specs(cfg, dist)[0]
    S = cache["layers"][0]["k"].shape[1]
    cspecs = shd.decode_cache_specs(cfg, token.shape[0], S, dist)
    blocks = shd.shard_tree(cache, cspecs, dist)
    before = [(x.shape, x.dtype) for x in leaves(blocks)]
    logits, new = M.decode_step(cfg, shd.shard_tree(params, specs, dist),
                                blocks, token, pos, dist=dist)
    kept = before == [(x.shape, x.dtype) for x in leaves(new)]
    return logits, shd.unshard_tree(new, cspecs, dist), kept


def _decode_bytes(cfg, dist, params, cache_len):
    """COLLECTIVE_COUNTS of one decode_sp step against a zero cache of
    ``cache_len`` (batch 4, the last position)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    B = 4
    cache = M.init_cache(cfg, B, cache_len, device="cpu")
    cspecs = shd.decode_cache_specs(cfg, B, cache_len, dist)
    blocks = shd.shard_tree(cache, cspecs, dist)
    specs = shd.param_specs(cfg, dist)[0]
    pb = shd.shard_tree(params, specs, dist)
    C.reset_counts()
    M.decode_step(cfg, pb, blocks, torch.zeros((B, 1), dtype=torch.long),
                  torch.full((B,), cache_len - 1, dtype=torch.int32),
                  dist=dist)
    return {k: tuple(v) for k, v in C.COLLECTIVE_COUNTS.items()}


def _serve(cfg, dist, params, tokens, n_new):
    """prefill, then greedy decode steps, on a mesh: the logits of each
    step and the whole cache at the end."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    specs = shd.param_specs(cfg, dist)[0]
    pb = shd.shard_tree(params, specs, dist)
    logits, cache = M.prefill(cfg, pb, {"tokens": tokens}, dist=dist)
    B, T = tokens.shape
    full = M.init_cache(cfg, B, T + n_new, device="cpu")
    cspecs = shd.decode_cache_specs(cfg, B, T + n_new, dist)
    M.write_cache(full, shd.unshard_tree(cache, shd.decode_cache_specs(
        cfg, B, T, dist), dist))
    cache = shd.shard_tree(full, cspecs, dist)
    out = [logits]
    for t in range(T, T + n_new):
        tok = out[-1].argmax(-1)[:, None]
        logits, cache = M.decode_step(cfg, pb, cache, tok,
                                      torch.full((B,), t, dtype=torch.int32),
                                      dist=dist)
        out.append(logits)
    return out, shd.unshard_tree(cache, cspecs, dist)


def _trainer(cfg, dist, tmp, total, data_cfg):
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t = Trainer(cfg=cfg, tcfg=TrainerConfig(ckpt_dir=tmp, total_steps=total,
                                            ckpt_every=2, seed=0),
                data=data_cfg, dist=dist, kernel_fns=ops.model_kernel_fns(),
                device="cpu")
    state, start = t.restore_or_init()
    t.run(state, start)
    return t.losses()


def body_2x2(rank, pl):
    """Every case of tests/test_torch_distributed.py on one 2 x 2 mesh
    (and a 4-rank 'stage' mesh for the pipeline)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.train.steps import opt_state_specs
    dist = _dist()
    out = {}
    cfg = _cfg("qwen3-8b", **pl["train"]["over"])
    tr = pl["train"]
    out["train"] = _train(cfg, dist, tr["params"], tr["batch"], tr["step"])[:2]
    out["zero2"] = _train(dataclasses.replace(cfg, zero=2), dist,
                          tr["params"], tr["batch"], tr["step"])[:2]
    fsdp = dataclasses.replace(cfg, fsdp=True)
    out["fsdp"] = _train(fsdp, dist, tr["params"], tr["batch"],
                         tr["step"])[:2] + (
        _grads(fsdp, dist, tr["params"], tr["batch"]),)
    af = dataclasses.replace(fsdp, optimizer="adafactor")
    whole, m, _, opt = _train(af, dist, tr["params"], tr["batch"],
                              tr["step"])
    out["adafactor"] = (whole, m, shd.unshard_tree(
        opt, opt_state_specs(af, dist), dist))
    out["moe"] = {name: _moe_case(_cfg(c["arch"], **c["over"]), dist,
                                  c["p"], c["x"])
                  for name, c in pl["moe"].items()}
    d = pl["decode"]
    sp_cfg = _cfg("qwen3-8b", decode_sp=True)
    out["decode_sp"] = _decode_sp(sp_cfg, dist, d["params"], d["cache"],
                                  d["token"], d["pos"])
    out["decode_bytes"] = [_decode_bytes(sp_cfg, dist, d["params"], n)
                           for n in (24, 96)]
    out["serve"] = _serve(_cfg("qwen3-8b"), dist, d["params"],
                          d["prompt"], 2)
    pp = pl["pipeline"]
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
    out["pipeline"] = pipeline_apply(
        mesh, "stage", 4, lambda W, x: torch.tanh(x @ W), pp["Ws"], pp["x"],
        n_micro=4)
    tmp = f"{pl['tmp']}/trainer"          # rank 0 writes, every rank reads
    first = _trainer(_cfg("qwen3-0.6b"), dist, tmp, 2, pl["data"])
    resumed = _trainer(_cfg("qwen3-0.6b"), dist, tmp, 4, pl["data"])
    out["trainer"] = first + resumed
    return out


def body_elastic(rank, pl):
    """4 x 2 on 8 ranks: a step and a checkpoint; then ranks 0-3 as a
    2 x 2 mesh restore it (each its block) and take the next step."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import dist_for
    from repro_torch.train.steps import (init_opt_state, make_train_step,
                                         opt_state_specs)
    cfg = _cfg("qwen3-0.6b")
    dist_a = _dist(4, 2)
    whole_a, m_a, blocks, opt = _train(cfg, dist_a, pl["params"],
                                       pl["batch"], pl["step"])
    specs_a = shd.param_specs(cfg, dist_a)[0]
    state_specs = {"params": specs_a,
                   "opt": opt_state_specs(cfg, dist_a)}
    ck.save(pl["ckpt"], {"params": blocks, "opt": opt}, step=1,
            shardings=(state_specs, dist_a))
    tdist.barrier()
    mesh_b = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                        mesh_dim_names=("data", "model"))
    dist_b = dist_for(mesh_b)
    if rank >= 4:
        return None
    specs_b = shd.param_specs(cfg, dist_b)[0]
    like_p = shd.shard_tree(pl["params"], specs_b, dist_b)
    like = {"params": like_p, "opt": init_opt_state(cfg, like_p, dist_b)}
    shardings = ({"params": specs_b,
                  "opt": opt_state_specs(cfg, dist_b)}, dist_b)
    state, step = ck.restore(pl["ckpt"], like, shardings=shardings)
    # the restored blocks against the blocks of the tree the 4 x 2 run
    # saved, cut for the 2 x 2 mesh
    want = shd.shard_tree(whole_a, specs_b, dist_b)
    from repro_torch.core.tree import leaves
    same = all(torch.equal(a, b) for a, b in zip(leaves(state["params"]),
                                                 leaves(want)))
    new, opt_b, m_b = make_train_step(cfg, dist_b)(
        state["params"], state["opt"], pl["batch"], pl["step"] + 1)
    return {"whole_a": whole_a, "m_a": m_a, "step": step, "same": same,
            "opt_step": int(state["opt"]["step"]),
            "whole_b": shd.unshard_tree(new, specs_b, dist_b),
            "m_b": {k: float(v) for k, v in m_b.items()}}


def _max_over_ranks(value):
    """The largest of every rank's float ``value``."""
    t = torch.tensor([float(value)])
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return float(t[0])


def _of_scale(got, want) -> float:
    """The largest difference of ``got`` from ``want`` over want's
    largest magnitude (inf for another shape or dtype)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    want = want.double()
    return float((got.double() - want).abs().max()) / \
        max(float(want.abs().max()), 1e-30)


def _prefill_decode(cfg, dist, params, tokens, T, cache_len, one_prefill):
    """prefill of ``tokens[:, :T]`` on the rank's blocks, then a decode
    step for each later token: (the logits of each, the whole cache at
    the end, the largest difference of a rank's prefill cache block from
    the block ``cache_specs`` lays out of the one-device prefill's cache
    over that block's scale,
    whether every decode kept the blocks' shapes and dtypes, the
    COLLECTIVE_COUNTS of the last step and of that step on a cache twice
    as long)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    B = tokens.shape[0]
    pb = shd.shard_tree(params, shd.param_specs(cfg, dist)[0], dist)
    logits, cache = M.prefill(cfg, pb, {"tokens": tokens[:, :T]}, dist=dist)
    lay = shd.cache_specs(cfg, ShapeConfig("p", T, B, "decode"), dist)[0]
    layout = _max_over_ranks(max(
        _of_scale(a, shd.block(b, s, dist)) for a, b, s in
        zip(leaves(cache), leaves(one_prefill), shd.spec_leaves(lay))))
    cspecs = shd.decode_cache_specs(cfg, B, cache_len, dist)
    if cache_len != T:                  # room for the new tokens
        full = M.init_cache(cfg, B, cache_len, device="cpu")
        M.write_cache(full, shd.unshard_tree(
            cache, shd.decode_cache_specs(cfg, B, T, dist), dist))
        cache = shd.shard_tree(full, cspecs, dist)
    before = [(x.shape, x.dtype) for x in leaves(cache)]
    outs, kept = [logits], True

    def step(cache, t):
        C.reset_counts()
        out = M.decode_step(cfg, pb, cache, tokens[:, t:t + 1],
                            torch.full((B,), t, dtype=torch.int32),
                            dist=dist)
        return out + ({k: tuple(v) for k, v in
                       C.COLLECTIVE_COUNTS.items()},)
    for t in range(T, tokens.shape[1]):
        logits, cache, counts = step(cache, t)
        kept &= before == [(x.shape, x.dtype) for x in leaves(cache)]
        outs.append(logits)
    # the last step again on a zero cache twice as long
    longer = shd.shard_tree(M.init_cache(cfg, B, 2 * cache_len, device="cpu"),
                            shd.decode_cache_specs(cfg, B, 2 * cache_len,
                                                   dist), dist)
    counts = (counts, step(longer, tokens.shape[1] - 1)[2])
    return (outs, shd.unshard_tree(cache, cspecs, dist), layout, kept,
            counts)


def body_tp(rank, pl):
    """Every case of tests/test_torch_dist_tp.py on one 2 x 2 mesh: the
    train steps (the whole new parameters, the metrics, the whole
    gradient from the blocks') and the prefill-and-decode runs."""
    dist = _dist()
    out = {"train": {}, "decode": {}}
    for name, c in pl["train"].items():
        cfg = _cfg(c["arch"], **c["over"])
        whole, m = _train(cfg, dist, c["params"], c["batch"], c["step"])[:2]
        out["train"][name] = (whole, m, _grads(cfg, dist, c["params"],
                                               c["batch"]))
    for name, c in pl["decode"].items():
        cfg = _cfg(c["arch"], **c["over"])
        out["decode"][name] = _prefill_decode(
            cfg, dist, c["params"], c["tokens"], c["T"], c["cache_len"],
            c["prefill_cache"])
    return out


def _layer_inputs(fn):
    """(``fn()``, the residual each layer took: what the model handed
    ``torch.utils.checkpoint.checkpoint`` as x, remat on)."""
    import torch.utils.checkpoint as ckpt
    seen, plain = [], ckpt.checkpoint

    def spy(f, x, *args, **kw):
        seen.append(x)
        return plain(f, x, *args, **kw)
    ckpt.checkpoint = spy
    try:
        return fn(), seen
    finally:
        ckpt.checkpoint = plain


def _saved_residuals(cfg, dist, params, batch):
    """train_loss and its backward on the rank's blocks: (the shape of
    the residual each layer took, the bytes of those residuals autograd
    saved for the backward, read with ``saved_tensors_hooks``)."""
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    blocks = shd.shard_tree(params, shd.param_specs(cfg, dist)[0], dist)
    for t in leaves(blocks):
        t.requires_grad_()
    packed = {}

    def pack(t):
        packed[(t.data_ptr(), tuple(t.shape))] = t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        (loss, _), xs = _layer_inputs(
            lambda: M.train_loss(cfg, blocks, batch, dist=dist))
    loss.backward()
    return ([tuple(x.shape) for x in xs],
            sum(packed.get((x.data_ptr(), tuple(x.shape)), 0) for x in xs))


def body_act_shard(rank, pl):
    """Every case of tests/test_torch_act_shard.py on one 2 x 2 mesh,
    under each ``act_shard``: reduced qwen3-8b's train step (the whole
    new parameters, the metrics), its prefill and two decode steps, the
    residual each layer took and what remat saved of it (also at T =
    15), and the whole gradient of the other cases."""
    dist = _dist()
    out = {}
    q = pl["qwen"]
    for mode in pl["modes"]:
        cfg = _cfg("qwen3-8b", remat=True, act_shard=mode)
        out[mode] = {
            "train": _train(cfg, dist, q["params"], q["batch"],
                            q["step"])[:2],
            "serve": _serve(cfg, dist, q["params"], q["prompt"], 2),
            "saved": _saved_residuals(cfg, dist, q["params"], q["batch"]),
            "saved15": _saved_residuals(cfg, dist, q["params"],
                                        q["batch15"]),
            "grads": {name: _loss_grads(_cfg(c["arch"], act_shard=mode,
                                             **c["over"]),
                                        dist, c["params"], c["batch"])
                      for name, c in pl["grads"].items()}}
    return out


def _loss_grads(cfg, dist, params, batch):
    """(the loss, the whole gradient gathered from the blocks')."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.steps import _loss_and_grads
    specs = shd.param_specs(cfg, dist)[0]
    loss, _, grads = _loss_and_grads(cfg, shd.shard_tree(params, specs, dist),
                                     batch, None, dist)
    return float(loss), shd.unshard_tree(grads, specs, dist)
