"""Multi-pod dry run (counterpart of ``repro/launch/dryrun.py``): rank 0 of
each (arch x shape x mesh) cell's production mesh, counted per device.

The reference lowers and compiles every cell for 256 ('data' 16 x
'model' 16) and 512 ('pod' 2 x 16 x 16) devices without running it, and
reads XLA's memory, cost and collectives off the compiled module.
PyTorch has no compile-without-run, so the port RUNS rank 0 of the
production mesh, in one process: the default group is torch's fake
process group at world 256 or 512 (``launch.mesh.fake_world``; its
collectives move nothing), and the port's own sharded step
(``train.steps.make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` with ``dist=``, ``distributed.sharding``'s specs)
runs on rank 0's blocks on a device of the caller's choosing:

* ``cuda`` (the default): the step runs on the card through the hand
  kernels, and its memory is measured;
* ``meta``: shapes only, on any machine; counts only (the temp size is
  None);
* ``cpu``: the tests, at reduced size.

The counts (FLOPs, bytes, collectives) are the same on all three
(``launch.hlo_analysis``: the counter, which counts each hand kernel's
operator by formula whatever computes it). An aten op the counter has
no rule for is listed in ``counts.unknown`` (its bytes counted, its
FLOPs not) and printed. They are PER DEVICE,
rank 0's, the counterpart of the reference's post-SPMD HLO. Where a
dimension does not divide its axes (long_500k's batch of 1 over 16 data
ranks), the port keeps the batch whole on every rank, the reference's
replicated-batch case, and rank 0 holds what every rank holds.

Each record (``RESULTS/<arch>__<shape>__<mesh>.json``) has the
reference's keys, so ``core.ici_gating.phases_from_dryrun`` reads it
unchanged: ``memory`` (argument, output, alias and temp bytes of rank
0; no generated code), ``cost`` (``flops``, ``bytes_accessed``),
``collectives`` by HLO op and ``collective_link_bytes``, ``compile_s``
(here the wall seconds of the run), and for the 'single' mesh the
accounting pass ``acct``: the step with 1 and 2 layer periods
(``models.model.stack_plan``), single-chunk attention, ``L2 - L1`` the
``per_layer_*`` and ``total = L1 + (n_scan - 1)(L2 - L1)``.

On the card ``argument_size_in_bytes`` is rank 0's parameter,
optimizer-state and batch (or cache) tensors: the port's entry points
take the GLOBAL batch on every rank (``models.model``), so the batch
counts whole; ``temp_size_in_bytes`` is the step's peak allocation
(``torch.cuda.max_memory_allocated``) less what was allocated before
it, the arguments. A failure (an out-of-memory error among them) is
recorded verbatim (``error``, ``traceback``), never replaced by a
``meta`` count.

How the count differs from XLA's:
  * FLOPs are counted op by op as ``HloCostAnalysis`` counts them, but
    eagerly: every elementwise op on its own, and bytes as each op's
    operands and results (no fusion), so ``bytes_accessed`` exceeds
    XLA's;
  * the reference's HLO keeps the wkv and Mamba time recurrences
    inside while loops, so its records count a loop body once (its
    roofline adds them back analytically); the port counts them whole
    (wkv by the reference's formula, Mamba's scan op by op), so rwkv6
    and jamba are not held to the reference's FLOPs;
  * attention is counted over the whole T x S (the reference's
    accounting pass computes it at one chunk), in the full-depth pass
    too, where the reference's chunked scan hides its trip count.

``implied_bytes`` derives the bytes a cell's collectives move on rank 0
by (op, axis) from the specs alone; a run's ``collective_bytes`` is
held to it (tests and ``chip_smoke.py``). A train record's
``remat_residuals`` states what remat keeps rank 0 between layers: a
layer's input each, the rank's block of the residual
(``sharding.act_spec``; ``remat_residual_bytes``), beside what the
whole residual would take.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \\
      --mesh single [--device cuda|meta|cpu]
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
      [--skip-acct] [--skip-existing]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cells_for, get_config
from repro_torch.configs.base import input_specs
from repro_torch.core.tree import leaves, paths, tree_map
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_wkv
from repro_torch.launch import hlo_analysis as hla
from repro_torch.launch.mesh import dist_for, fake_world, make_test_mesh
from repro_torch.models import mamba as mb
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_mod
from repro_torch.train.steps import (init_opt_state, make_decode_step,
                                     make_prefill_step, make_train_step,
                                     moment_shards, stacked_specs)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

#: mesh kind -> the production mesh's shape: (data, model) or (pod,
#: data, model)
MESHES = {"single": (16, 16), "multi": (2, 16, 16)}


def _fill(meta, device, gen):
    """A tensor of ``meta``'s shape and dtype on ``device``: a float
    matrix small normals, a float vector ones (norm gains), integers
    zeros (the values of a dry run do not matter; finite ones keep the
    kernels' checks and the router honest)."""
    if meta.dtype.is_floating_point and meta.dim() >= 2:
        return (torch.randn(meta.shape, generator=gen, device=device)
                * 0.02).to(meta.dtype)
    if meta.dtype.is_floating_point:
        return torch.ones(meta.shape, dtype=meta.dtype, device=device)
    return torch.zeros(meta.shape, dtype=meta.dtype, device=device)


def _materialize(tree, device, gen):
    return tree_map(lambda t: _fill(t, device, gen), tree)


def _zeros(tree, device):
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device=device), tree)


def _batch(cfg, shape, device, gen):
    """The global batch of a train or prefill cell on ``device``."""
    out = {}
    for k, m in input_specs(cfg, shape).items():
        if m.dtype.is_floating_point:
            out[k] = torch.randn(m.shape, generator=gen,
                                 device=device).to(m.dtype)
        elif m.dtype == torch.bool:
            out[k] = torch.ones(m.shape, dtype=torch.bool, device=device)
        else:
            out[k] = torch.randint(0, cfg.vocab, m.shape, generator=gen,
                                   device=device, dtype=m.dtype)
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata for t in leaves(tree)}


def _meta_args(cfg, shape, dist):
    """The ``meta`` tensors of rank 0's step arguments: (parameter
    blocks, optimizer-state blocks, global batch) for train, (blocks,
    batch) for prefill, (blocks, cache blocks, token, position) for
    decode."""
    p_meta = model_lib.init_params(cfg, 0, device="meta", dist=dist)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return p_meta, init_opt_state(cfg, p_meta, dist), \
            input_specs(cfg, shape)
    if shape.kind == "prefill":
        return p_meta, input_specs(cfg, shape)
    whole = model_lib.init_cache(cfg, B, S, device="meta")
    cache = shd.shard_tree(whole, shd.decode_cache_specs(cfg, B, S, dist),
                           dist)
    return (p_meta, cache, torch.empty((B, 1), dtype=torch.int32,
                                       device="meta"),
            torch.empty((B,), dtype=torch.int32, device="meta"))


class CellFailed(RuntimeError):
    """A cell's step failed; ``memory`` holds what is known of it (its
    argument bytes, the card's peak when it failed)."""

    def __init__(self, error, memory):
        super().__init__(f"{type(error).__name__}: {error}")
        self.memory = memory


def lower_cell(cfg, shape, dist, device) -> dict:
    """Run rank 0's step of one cell once under the counter (the
    reference lowers and compiles it). Returns {"counts", "unknown",
    "log", "collective_bytes", "memory", "launches"}; raises
    ``CellFailed`` (from the step's own error) when it fails."""
    dev = torch.device(device)
    meta = _meta_args(cfg, shape, dist)
    arg_bytes = _nbytes(meta)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        return _lower(cfg, shape, dist, dev, meta, arg_bytes)
    except Exception as e:  # noqa: BLE001 - re-raised with what is known
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else None
        raise CellFailed(e, {"argument_size_in_bytes": arg_bytes,
                             "peak_size_in_bytes": peak}) from e


def _lower(cfg, shape, dist, dev, meta, arg_bytes):
    if dev.type == "meta":
        args = meta
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = _materialize(meta[0], dev, gen)
        if shape.kind == "train":          # the optimizer state as inited
            args = (params, _zeros(meta[1], dev), _batch(cfg, shape, dev,
                                                         gen))
        elif shape.kind == "prefill":
            args = (params, _batch(cfg, shape, dev, gen))
        else:                              # a cache, the last position
            args = (params, _zeros(meta[1], dev), _zeros(meta[2], dev),
                    torch.full(meta[3].shape, shape.seq_len - 1,
                               dtype=torch.int32, device=dev))
    fns = ops.model_kernel_fns()
    if shape.kind == "train":
        fn = make_train_step(cfg, dist, fns)

        def run():
            return fn(*args, 0)
    else:
        fn = (make_prefill_step if shape.kind == "prefill" else
              make_decode_step)(cfg, dist, fns)

        def run():
            with torch.no_grad():
                return fn(*args)
    C.reset_counts()
    launched = _launches()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    with hla.CostCounter() as counter:
        out = run()
    temp = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        temp = torch.cuda.max_memory_allocated(dev) - before
    outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
    shared = _storages(args)
    return {
        "counts": counter.counts(),
        "unknown": dict(counter.unknown),
        "log": list(C.COLLECTIVE_LOG),
        "collective_bytes": {"/".join(k): list(v) for k, v in
                             C.COLLECTIVE_COUNTS.items()},
        "memory": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": _nbytes(outs),
            "alias_size_in_bytes": sum(
                t.numel() * t.element_size() for t in outs
                if t.untyped_storage()._cdata in shared),
            "temp_size_in_bytes": temp},
        "launches": {k: {v: n - launched[k][v] for v, n in now.items()}
                     for k, now in _launches().items()},
    }


def _launches() -> dict:
    """The hand kernels' launch counts by kernel and variant."""
    return {"flash_attention": dict(fa.VARIANT_LAUNCHES),
            "flash_attention_bwd": dict(fa.BWD_VARIANT_LAUNCHES),
            "wkv": {"kernel": rwkv6_wkv.LAUNCHES},
            "wkv_bwd": {"kernel": rwkv6_wkv.BWD_LAUNCHES}}


def _acct_cfg(cfg, shape, n_periods):
    """Config for the accounting pass: n_periods periods, unrolled,
    single-chunk attention."""
    _, _, period = model_lib.stack_plan(cfg)
    n_layers = cfg.first_dense + n_periods * period
    return dataclasses.replace(
        cfg, n_layers=n_layers, unroll=True,
        attn_chunk=max(shape.seq_len, 1),
        # MoE capacity depends only on tokens/experts; unchanged.
    )


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, device="cuda",
             skip_acct=False, verbose=True, cfg=None, shape=None,
             mesh_shape=None, results=None) -> dict:
    """One cell's record, written to ``results`` (``RESULTS``). ``cfg``,
    ``shape`` and ``mesh_shape`` ((data, model) or (pod, data, model))
    override the production ones (the tests' reduced cells). Raises
    when a default process group is already up."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    dev = resolve_device(device)
    dims = MESHES[mesh_kind] if mesh_shape is None else tuple(mesh_shape)
    n = math.prod(dims)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "n_devices": n, "ok": False, "device": dev.type}
    with fake_world(n):
        dist = dist_for(make_test_mesh(*dims[-2:], pod=dims[0]
                                       if len(dims) == 3 else 0))
        sizes = C.axis_sizes(dist.mesh)
        rec["remat_residuals"] = remat_residual_bytes(cfg, dist, shape)
        t0 = time.time()
        try:
            res = lower_cell(cfg, shape, dist, dev)
            rec["memory"] = hla.memory_stats(res["memory"])
            rec["cost"] = hla.cost_stats(res["counts"])
            coll = hla.collective_stats(res["log"], sizes)
            rec["collectives"] = coll.by_op()
            rec["collective_link_bytes"] = coll.total_link_bytes
            rec["counts"] = dict(res["counts"], unknown=res["unknown"])
            rec["collective_bytes"] = res["collective_bytes"]
            rec["implied_bytes"] = {"/".join(k): v for k, v in
                                    implied_bytes(cfg, dist, shape).items()}
            rec["launches"] = res["launches"]
            rec["ok"] = True
            del res
        except CellFailed as e:        # recorded verbatim
            rec["error"] = str(e)
            rec["traceback"] = "".join(traceback.format_exception(
                e.__cause__))[-2000:]
            rec["memory"] = hla.memory_stats(dict(
                e.memory, temp_size_in_bytes=None))
            rec["peak_size_in_bytes"] = e.memory["peak_size_in_bytes"]
        _free(dev)
        rec["compile_s"] = time.time() - t0

        if rec["ok"] and not skip_acct and mesh_kind == "single":
            try:
                acct = {}
                unknown = rec["counts"]["unknown"]
                for k in (1, 2):
                    r = lower_cell(_acct_cfg(cfg, shape, k), shape, dist,
                                   dev)
                    _free(dev)
                    for op, calls in r["unknown"].items():
                        unknown[op] = unknown.get(op, 0) + calls
                    acct[k] = {
                        "cost": hla.cost_stats(r["counts"]),
                        "coll_link_bytes": hla.collective_stats(
                            r["log"]).total_link_bytes,
                        "dot_flops": r["counts"]["dot_flops"],
                        "collectives": hla.collective_stats(
                            r["log"]).by_op(),
                        "collective_bytes": r["collective_bytes"],
                        "launches": r["launches"],
                    }
                _, n_scan, _ = model_lib.stack_plan(cfg)
                d_fl = acct[2]["cost"]["flops"] - acct[1]["cost"]["flops"]
                d_by = (acct[2]["cost"]["bytes_accessed"]
                        - acct[1]["cost"]["bytes_accessed"])
                d_cl = acct[2]["coll_link_bytes"] - acct[1]["coll_link_bytes"]
                rec["acct"] = {
                    "L1": acct[1], "L2": acct[2],
                    "per_layer_flops": d_fl,
                    "per_layer_bytes": d_by,
                    "per_layer_coll_link_bytes": d_cl,
                    "per_layer_dot_flops": acct[2]["dot_flops"]
                    - acct[1]["dot_flops"],
                    "total_flops": acct[1]["cost"]["flops"]
                    + (n_scan - 1) * d_fl,
                    "total_bytes": acct[1]["cost"]["bytes_accessed"]
                    + (n_scan - 1) * d_by,
                    "total_coll_link_bytes":
                        acct[1]["coll_link_bytes"] + (n_scan - 1) * d_cl,
                }
            except CellFailed as e:
                rec["acct_error"] = str(e)
                _free(dev)

    out_dir = Path(results) if results is not None else RESULTS
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{arch}__{shape_name}__{mesh_kind}.json"
    out.write_text(json.dumps(rec, indent=1))
    if verbose:
        mem = rec.get("memory", {})
        temp = mem.get("temp_size_in_bytes")
        kept = rec["remat_residuals"]
        print(f"[{rec['compile_s']:7.1f}s] {arch:22s} {shape_name:12s} "
              f"{mesh_kind:6s} {dev.type:4s} ok={rec['ok']} temp/dev="
              + ("n/a" if temp is None else f"{temp / 2**30:.2f}GiB")
              + f" args/dev={mem.get('argument_size_in_bytes', 0) / 2**30:.2f}"
              f"GiB" + ("" if kept is None else
                        f" remat residuals={kept['saved'] / 2**30:.2f}GiB "
                        f"(whole {kept['whole'] / 2**30:.2f})"), flush=True)
        if not rec["ok"]:
            print("  ERROR:", rec["error"], flush=True)
        if unknown_ops(rec):
            print("  UNKNOWN ops (no FLOPs counted):", unknown_ops(rec),
                  flush=True)
    return rec


def unknown_ops(rec) -> dict:
    """The aten ops of a record's runs that the counter has no rule for
    (their bytes are counted, their FLOPs are not): {op: calls}."""
    return rec.get("counts", {}).get("unknown", {})


# ---------------------------------------------------------------------------
# The collective bytes the specs imply
# ---------------------------------------------------------------------------

def _layer_use(cfg, dist, part, name, decode):
    """How a layer uses leaf ``part``/``name``: (keep axes, partial
    axes) of its ``gather_param`` (``models.model.TP_USE`` where the
    part runs tensor-parallel)."""
    ma = dist.model_axis
    if part == "moe":
        return (ma,), ()
    tp = {"attn": shd.decode_kv_heads if decode else
          model_lib.tp_attention, "mlp": model_lib.tp_mlp,
          "rwkv": model_lib.tp_rwkv, "mamba": model_lib.tp_mamba}.get(part)
    use = model_lib.TP_USE[part].get(name) if tp and tp(cfg, dist) \
        else None
    if use == "keep":
        return (ma,), ()
    if use == "partial":
        return (), (ma,)
    return (), ()


def _gather_bytes(out, dist, spec, shape, esize, keep, partial, uses,
                  backward):
    """``gather_param``'s collectives on a block of ``spec`` of the
    whole ``shape``: ``uses`` forwards, one backward."""
    sizes = C.axis_sizes(dist.mesh)
    data = set(C.as_axes(dist.data_axes))
    cur = [n // math.prod(sizes[a] for a in C.as_axes(e))
           for n, e in zip(shape, tuple(spec) + (None,) * len(shape))]
    for i, ent in enumerate(spec):
        axes = C.as_axes(ent)
        if axes and not set(axes) <= set(keep):
            out[("all_gather", "+".join(axes))] += \
                uses * math.prod(cur) * esize
            cur[i] *= math.prod(sizes[a] for a in axes)
    if not backward:
        return
    if partial:
        out[("psum", "+".join(partial))] += math.prod(cur) * esize
    used = set()
    for i, ent in enumerate(spec):
        axes = C.as_axes(ent)
        used |= set(axes)
        if not axes or set(axes) <= set(keep):
            continue
        if set(axes) <= data:
            out[("psum_scatter", "+".join(axes))] += math.prod(cur) * esize
        cur[i] //= math.prod(sizes[a] for a in axes)
    rest = [a for a in C.as_axes(dist.data_axes) if a not in used]
    if rest:
        out[("psum", "+".join(rest))] += math.prod(cur) * esize


def _adafactor_bytes(out, cfg, dist, shapes):
    """The psums of adafactor's factored means and RMS clip on a mesh
    (``train.steps._adafactor_shards``)."""
    from repro_torch.optim.adafactor import groups
    names = tuple(dist.mesh.mesh_dim_names)
    sizes = C.axis_sizes(dist.mesh)
    stacked = stacked_specs(cfg, dist)

    def psum(spec, dims, numel):
        used = {a for d in dims for a in C.as_axes(spec[d])}
        axes = tuple(a for a in names if a in used)
        if axes:
            out[("psum", "+".join(axes))] += numel * 4
    from repro_torch.core.tree import get
    for ref, members in groups(shapes, model_lib.stack_plan(cfg)):
        spec = stacked[ref]
        whole = list(get(shapes, members[0]).shape)
        if ref[0] == "stack":
            whole = [len(members)] + whole
        g = [n // math.prod(sizes[a] for a in C.as_axes(e))
             for n, e in zip(whole, spec)]
        nd = len(g)
        if nd >= 2:
            psum(spec, (nd - 1,), math.prod(g[:-1]))
            psum(spec, (nd - 2,), math.prod(g[:-2]) * g[-1])
            psum(spec, (nd - 2,), math.prod(g[:-2]))
        psum(spec, range(nd), 1)


def _decode_combine_bytes(out, cfg, dist, shape, b):
    """A decode's attention combine a layer over a cache whose sequence
    is cut: the partial softmax's ``pmax`` and two ``psum``s over the
    sequence's axes."""
    m = dist.model_size
    specs = shd.decode_cache_specs(cfg, shape.global_batch, shape.seq_len,
                                   dist)["layers"]
    mla = cfg.attn_type == "mla"
    H = cfg.n_heads // m if shd.decode_kv_heads(cfg, dist) else cfg.n_heads
    dv = cfg.mla.kv_lora_rank if mla else cfg.d_head
    for i, (kind, _) in enumerate(model_lib.layer_kinds(cfg)):
        if kind != "attn":
            continue
        seq = specs[i]["c_kv" if mla else "k"][1]
        if seq is not None:
            key = "+".join(C.as_axes(seq))
            out[("pmax", key)] += b * H * 4
            out[("psum", key)] += b * H * 4 + b * H * dv * 4


def remat_residual_bytes(cfg, dist, shape) -> dict:
    """What remat keeps a rank between layers in one (micro)batch of a
    train cell: a layer's input each, the rank's block of the residual
    (``sharding.act_spec``): {"layers", "block_bytes" (one), "saved"
    (layers x block), "whole" (layers x the rank's whole residual, what
    a layout without ``act_shard`` would keep)}; None for other cells
    and without remat."""
    if shape.kind != "train" or not cfg.remat:
        return None
    B = shape.global_batch // cfg.microbatches
    b = B // dist.data_size if B % dist.data_size == 0 else B
    whole = b * shape.seq_len * cfg.d_model * \
        (torch.finfo(cfg.dtype).bits // 8)
    act_dim = model_lib.act_dim(cfg, dist, (B, shape.seq_len,
                                             cfg.d_model))
    block = whole // (dist.model_size if act_dim is not None else 1)
    return {"layers": cfg.n_layers, "block_bytes": block,
            "saved": cfg.n_layers * block, "whole": cfg.n_layers * whole}


def implied_bytes(cfg, dist, shape) -> collections.Counter:
    """The bytes rank 0 hands to each collective of one step of
    ``shape`` (its kind, global batch and sequence) by (op, axis), from
    the specs alone: the parameter gathers at use (every forward pass of
    a layer, a remat recompute among them) and their gradients'
    reduce-scatters and sums, the residual's layout (``act_spec``: the
    embedding cut to the block, each sublayer's gather of it before its
    norm and its output's reduce-scatter into it, or under ``"none"``
    the tensor-parallel sums, with their transposes), the MoE combine
    and router statistics, the prefill's kv rows where the cache does
    not keep the rank's kv heads, a decode's attention combine, a tied
    table's vocab-parallel lookup, the vocab-parallel loss's ``pmax``
    and ``psum`` and the logits' blocks and rows, the loss and gradient
    norm, adafactor's factored statistics. A remat recompute stops at
    the layer's last saved tensor, so the collectives after it (a
    layer's last output laid out: an MLP's reduce-scatter, a gathered
    d-block) run once."""
    out: collections.Counter = collections.Counter()
    train, decode = shape.kind == "train", shape.kind == "decode"
    k_mb = cfg.microbatches if train else 1
    B = shape.global_batch // k_mb
    split = B % dist.data_size == 0
    b = B // dist.data_size if split else B
    T = 1 if decode else shape.seq_len
    d, esize = cfg.d_model, torch.finfo(cfg.dtype).bits // 8
    ma, m = dist.model_axis, dist.model_size
    dkey = "+".join(C.as_axes(dist.data_axes))
    remat = train and cfg.remat
    passes = 2 if remat else 1
    act = b * T * d * esize
    act_dim = model_lib.act_dim(cfg, dist, (B, T, d))
    act_blk = act // m
    specs, shapes = shd.param_specs(cfg, dist)
    body: collections.Counter = collections.Counter()
    vp = model_lib.vocab_parallel(cfg, dist)

    # parameters
    used_top = {"final_norm", "head"}
    if cfg.frontend != "audio_frames" or cfg.tie_embeddings:
        used_top.add("embed")
    for (path, leaf), spec in zip(paths(shapes), shd.spec_leaves(specs)):
        if path[0] == "layers":
            part = path[2] if len(path) > 3 else None
            keep, partial = _layer_use(cfg, dist, part, path[-1], decode) \
                if part else ((), ())
            uses, bwd = passes, train
        else:
            vocab = path[0] == "head" or (path[0] == "embed" and
                                          cfg.tie_embeddings)
            keep, partial, uses = ((ma,) if vp and vocab else ()), (), 1
            bwd = train and path[0] in used_top
        _gather_bytes(body, dist, spec, leaf.shape, leaf.element_size(),
                      keep, partial, uses, bwd)

    # the residual's layout (models.model._norm_in, _out, _from_d_block)
    def enter(tp, where, size=act_blk):
        if act_dim is None:
            if tp and train:
                body[("psum", ma)] += act              # copy_to's
            return
        where[("all_gather", ma)] += size
        if tp and train:      # layers.gathered_rms_norm's backward
            body[("psum_scatter", ma)] += act
            if act_dim == 2:                           # row sums, gain
                body[("psum", ma)] += b * T * 4
                body[("all_gather", ma)] += d // m * 4
            else:
                body[("psum", ma)] += d * 4

    def leave(tp, where):
        if act_dim is None:
            if tp:
                where[("psum", ma)] += act
            return
        if tp:
            where[("psum_scatter", ma)] += act
        if train:
            body[("all_gather", ma)] += act_blk        # its transpose

    def from_d_block(where):
        if act_dim != 2:
            where[("all_gather", ma)] += act_blk
            leave(False, where)

    # activations, layer by layer
    tp_attn = not decode and model_lib.tp_attention(cfg, dist)
    n_kv0 = len(model_lib.tp_kv_heads(cfg, m, 0)) if tp_attn else 0
    gather_kv = shape.kind == "prefill" and not shd.decode_kv_heads(cfg,
                                                                    dist)
    for kind, ffn in model_lib.layer_kinds(cfg):
        # whether the mixer and the FFN are tensor-parallel (RWKV's
        # channel mix runs on the mixer's heads)
        tp1 = model_lib.tp_mixer(cfg, dist, kind, decode)
        tp2 = tp1 if kind == "rwkv" else \
            ffn == "mlp" and model_lib.tp_mlp(cfg, dist)
        fwd = collections.Counter()      # once a forward pass
        tail = collections.Counter()     # once: after the last saved tensor
        enter(tp1, fwd)
        leave(tp1, fwd)
        if kind == "attn" and gather_kv and tp_attn:
            fwd[("all_gather", ma)] += 2 * b * T * n_kv0 * cfg.d_head * esize
        if kind == "mamba" and tp1:
            _, dt_rank, n_state, _ = mb.mamba_dims(cfg)
            proj = b * T * (dt_rank + 2 * n_state) * esize
            fwd[("psum", ma)] += proj              # x_proj's partial sums
            body[("psum", ma)] += proj if train else 0    # their copy_to
        enter(tp2, fwd)
        if kind == "rwkv" and tp1:
            fwd[("psum_scatter", ma)] += act       # cm_wv's
            if train:
                body[("all_gather", ma)] += act_blk    # its transpose
            from_d_block(tail)
        elif kind == "rwkv":
            leave(False, tail)
        elif ffn == "moe":
            scatter = moe_mod.combine_scatters(cfg, dist)
            fwd[("psum_scatter" if scatter else "psum", ma)] += act
            if split:
                fwd[("psum", dkey)] += 2 * cfg.n_experts * 4
            if train:
                body[("psum", ma)] += act + b * T * cfg.top_k * 4  # copy_to's
            if scatter:
                if train:
                    body[("all_gather", ma)] += act_blk   # its transpose
                from_d_block(tail)
            else:
                leave(False, tail)
        else:
            leave(tp2, tail)
        for key, v in fwd.items():
            body[key] += passes * v
        for key, v in tail.items():
            body[key] += v
    if decode:
        _decode_combine_bytes(body, cfg, dist, shape, b)

    # the embedding and the head
    if vp and cfg.tie_embeddings and cfg.frontend != "audio_frames":
        n_tok = T - (cfg.n_frontend_tokens if cfg.frontend ==
                     "vision_patches" and not decode else 0)
        body[("psum", ma)] += b * n_tok * d * esize      # the lookup
    if act_dim is not None and train and cfg.frontend != "audio_frames":
        body[("all_gather", ma)] += act_blk  # _constrain_act's transpose
    if train:
        enter(vp, body)                          # the final norm's input
        if vp:
            body[("pmax", ma)] += b * T * 4              # the loss's
            body[("psum", ma)] += 2 * b * T * 4
        if split:
            mask = cfg.frontend == "audio_frames" or (
                cfg.frontend == "vision_patches")
            body[("psum", dkey)] += (2 if mask else 1) * 4
    else:
        enter(False, body, act_blk if act_dim == 1 else b * d // m * esize)
        vpad = cfg.padded_vocab
        if vp:
            body[("all_gather", ma)] += b * (vpad // m) * 4
        if split:
            body[("all_gather", dkey)] += b * vpad * 4
    for key, v in body.items():
        out[key] += k_mb * v

    if train:
        every = "+".join(dist.mesh.mesh_dim_names)
        out[("psum", every)] += 4                        # grad_norm
        if cfg.optimizer == "adafactor":
            _adafactor_bytes(out, cfg, dist, shapes)
        else:
            for (path, leaf), spec, extra in zip(
                    paths(shapes), shd.spec_leaves(specs),
                    moment_shards(cfg, dist)[1]):
                if extra is not None:
                    n = C.axes_size(dist, extra[1])
                    blk = math.prod(
                        s // C.axes_size(dist, e) if C.as_axes(e) else s
                        for s, e in zip(leaf.shape, tuple(spec) + (None,)
                                        * leaf.dim()))
                    out[("all_gather", "+".join(C.as_axes(extra[1])))] += \
                        blk // n * leaf.element_size()
    return collections.Counter({k: v for k, v in out.items() if v})


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Rank 0 of each (arch x shape x mesh) cell's production "
        "mesh, counted per device; records under results/dryrun_torch/.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-acct", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card), meta (counts only, "
                    "any machine) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]

    total = ok = 0
    unknown = {}
    for arch in archs:
        cfg = get_config(arch)
        for cell in cells_for(cfg):
            if args.shape and cell.shape.name != args.shape:
                continue
            if not cell.run:
                print(f"[  skip ] {arch:22s} {cell.shape.name:12s} "
                      f"-- {cell.skip_reason}", flush=True)
                continue
            for mk in meshes:
                out = RESULTS / f"{arch}__{cell.shape.name}__{mk}.json"
                if args.skip_existing and out.exists() and \
                        json.loads(out.read_text()).get("ok"):
                    continue
                rec = run_cell(arch, cell.shape.name, mk,
                               device=args.device, skip_acct=args.skip_acct)
                total += 1
                ok += rec["ok"]
                if unknown_ops(rec):
                    unknown[out.stem] = unknown_ops(rec)
    print(f"dry-run complete: {ok}/{total} cells ran; ops without a "
          f"counting rule: " + (json.dumps(unknown) if unknown else
                                "none (every op of every cell counted)"),
          flush=True)


if __name__ == "__main__":
    main()
