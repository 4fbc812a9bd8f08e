"""Train, prefill and decode step factories (counterpart of
``repro/train/steps.py``).

``make_train_step`` closes over (cfg, dist, optimizer) and returns
``train_step(params, opt_state, batch, step) -> (params, opt_state,
metrics)``: the gradients from plain ``torch.autograd`` over
``models.model.train_loss`` (through the CUDA kernels' backward kernels
with ``kernel_fns = ops.model_kernel_fns()`` on the card), microbatches
accumulated in the parameters' dtype in the reference's order, the
optimizer update at the step's ``cosine_warmup`` rate. The reference
jits it; here it runs eagerly.

On a mesh (``dist``, a ``models.moe.DistContext``) every rank runs the
step on its blocks of the parameters (``distributed.sharding
.param_specs``) and of the optimizer state (``opt_specs``), with the
global batch (the same on every rank; a microbatch is a run of its
rows, in the reference's order, then split over the data axes):
  * ``cfg.zero >= 3`` (FSDP): each layer's blocks are all-gathered at
    use and their gradients reduce-scattered back to blocks;
  * ``cfg.zero == 2``: the parameters are replicated over 'data', their
    gradients all-reduced; the AdamW moments are also sharded over
    'data' where ``opt_extra_shard`` says, and each rank updates its
    moment block and the matching slice of the parameter, then
    all-gathers the slice;
  * AdamW updates blocks (exact: the update is elementwise); so does
    adafactor, its factored statistics' means and its RMS clip summed
    over the ranks that hold the other blocks of a leaf (its state the
    blocks of the reference's layout, ``opt_state_specs``);
  * ``grad_norm`` is over the whole tree with every element counted
    once (a block replicated over an axis is weighted down by its
    copies).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.tree import (get, leaves, paths, set_in, tree_map,
                                   unflatten)
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.models import model as model_lib
from repro_torch.models.model import stack_plan
from repro_torch.models.moe import as_dist
from repro_torch.optim import adafactor, make_optimizer
from repro_torch.optim.schedule import cosine_warmup


def _loss_and_grads(cfg, params, batch, kernel_fns, dist=None):
    """(loss, metrics, grads): grads in the parameters' structure and
    dtypes, zeros for a leaf the loss does not reach."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = leaves(live)
    loss, metrics = model_lib.train_loss(cfg, live, batch, kernel_fns,
                                         dist=dist)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, flat)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def opt_specs(cfg, dist):
    """The spec tree of the AdamW moments: ``param_specs``' with
    ``opt_extra_shard`` (ZeRO-2) applied leaf by leaf."""
    specs, shapes = shd.param_specs(cfg, dist)
    return shd.spec_tree_map(
        lambda shape, s: shd.opt_extra_shard(cfg, dist, s, shape), shapes,
        specs)


def opt_state_specs(cfg, dist):
    """The spec tree of a whole optimizer state on a mesh, its step
    replicated: AdamW's moments by ``opt_specs``; adafactor's factored
    statistics by their leaf's spec (the reference's dry run's): ``vr``
    all but its last entry, ``vc`` all but its second to last."""
    if cfg.optimizer == "adamw":
        ms = opt_specs(cfg, dist)
        return {"step": (), "m": ms, "v": ms}
    v: dict = {}
    for ref, spec in stacked_specs(cfg, dist).items():
        set_in(v, ref, {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
               if len(spec) >= 2 else {"v": spec})
    return {"step": (), "v": v}


def stacked_specs(cfg, dist) -> dict:
    """Adafactor's leaf (``optim.adafactor.groups``, the reference's
    stacked layout) -> its spec, one entry a dimension: its members'
    spec, behind None for the stack dim of a stack of layers."""
    specs, shapes = shd.param_specs(cfg, dist)
    out = {}
    for ref, members in adafactor.groups(shapes, stack_plan(cfg)):
        leaf = get(shapes, members[0])
        spec = tuple(get(specs, members[0]))
        spec += (None,) * (leaf.dim() - len(spec))
        out[ref] = (None,) + spec if ref[0] == "stack" else spec
    return out


def _adafactor_shards(cfg, dist):
    """``shards(ref, dims) -> (n, total)`` for ``adafactor_update`` on a
    mesh: the blocks the dims ``dims`` of leaf ``ref`` are cut into, and
    the sum over the ranks that hold them."""
    stacked = stacked_specs(cfg, dist)
    names = tuple(dist.mesh.mesh_dim_names)

    def shards(ref, dims):
        spec = stacked[ref]
        used = {a for d in dims for a in C.as_axes(spec[d])}
        axes = tuple(a for a in names if a in used)
        if not axes:
            return 1, lambda x: x
        return C.axes_size(dist, axes), \
            lambda x: C.all_reduce_(dist, axes, x.clone())
    return shards


def moment_shards(cfg, dist):
    """(param spec tree, the (dim, axes) of each leaf's moments' extra
    data shard or None, in leaf order)."""
    specs = shd.param_specs(cfg, dist)[0]

    def extra(spec, mspec):
        for i, (a, b) in enumerate(zip(tuple(spec) + (None,) * len(mspec),
                                       mspec)):
            if a != b:
                return i, b
        return None
    return specs, [extra(s, m) for s, m in zip(
        shd.spec_leaves(specs), shd.spec_leaves(opt_specs(cfg, dist)))]


def _slice(x, extra, dist):
    """The rank's slice of a parameter block along the moments' extra
    data shard (ZeRO-2)."""
    if extra is None:
        return x
    i, ent = extra
    return shd.block(x, (None,) * i + (ent,), dist)


def init_opt_state(cfg, params, dist=None):
    """The optimizer state of ``params`` (the rank's blocks on a mesh:
    the moments of each block's ZeRO-2 slice; adafactor's statistics of
    the blocks)."""
    opt_init, _ = make_optimizer(cfg)
    dist = as_dist(dist, "init_opt_state")
    if dist is None:
        return opt_init(params)
    if cfg.optimizer != "adamw":
        return opt_init(params)
    specs, extras = moment_shards(cfg, dist)
    return opt_init(unflatten(params, [_slice(p, e, dist) for p, e in
                                       zip(leaves(params), extras)]))


def _replicas(dist, spec) -> int:
    """How many ranks hold a copy of each element of a block."""
    sizes = C.axis_sizes(dist.mesh)
    used = {a for ent in spec for a in C.as_axes(ent)}
    return math.prod(n for a, n in sizes.items() if a not in used)


def make_train_step(cfg, dist=None, kernel_fns=None, peak_lr=3e-4,
                    warmup=100):
    dist = as_dist(dist, "make_train_step")
    _, opt_update = make_optimizer(cfg)
    if dist is not None:
        specs, extras = moment_shards(cfg, dist)
        copies = [_replicas(dist, s) for s in shd.spec_leaves(specs)]
        every_axis = tuple(dist.mesh.mesh_dim_names)
        if cfg.optimizer != "adamw":
            shards = _adafactor_shards(cfg, dist)

    def update(grads, opt_state, params, lr):
        if dist is None:
            return opt_update(grads, opt_state, params, lr)
        if cfg.optimizer != "adamw":
            return opt_update(grads, opt_state, params, lr, shards=shards)
        flat_p, flat_g = leaves(params), leaves(grads)
        p_sl = [_slice(p, e, dist) for p, e in zip(flat_p, extras)]
        g_sl = [_slice(g, e, dist) for g, e in zip(flat_g, extras)]
        new_sl, new_opt = opt_update(unflatten(grads, g_sl), opt_state,
                                     unflatten(params, p_sl), lr)
        new = [q if e is None else
               shd.unblock(q, (None,) * e[0] + (e[1],), dist)
               for q, e in zip(leaves(new_sl), extras)]
        return unflatten(params, new), new_opt

    def grad_norm(grads):
        if dist is None:
            return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                  for _, g in paths(grads)))
        local = sum(torch.sum(torch.square(g.float())) / n if n > 1 else
                    torch.sum(torch.square(g.float()))
                    for g, n in zip(leaves(grads), copies))
        return torch.sqrt(C.all_reduce_(dist, every_axis, local.clone()))

    def train_step(params, opt_state, batch, step):
        if cfg.microbatches > 1:
            k = cfg.microbatches
            # accumulate in the param dtype, as the reference: an f32
            # accumulator of a large model costs twice a bf16 one
            grads = tree_map(lambda p: torch.zeros_like(p), params)
            losses, ms = [], []
            for i in range(k):
                mb = {key: x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
                      for key, x in batch.items()}
                loss, m, g = _loss_and_grads(cfg, params, mb, kernel_fns,
                                             dist)
                grads = tree_map(
                    lambda c, gi: (c.float() + gi.float() / k).to(c.dtype),
                    grads, g)
                losses.append(loss)
                ms.append(m)
            loss = torch.mean(torch.stack(losses))
            metrics = {key: torch.mean(torch.stack([m[key] for m in ms]))
                       for key in ms[0]}
        else:
            loss, metrics, grads = _loss_and_grads(cfg, params, batch,
                                                   kernel_fns, dist)
        dev = leaves(params)[0].device
        lr = cosine_warmup(step, peak_lr=peak_lr, warmup=warmup, device=dev)
        new_params, new_opt = update(grads, opt_state, params, lr)
        gnorm = grad_norm(grads)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(cfg, dist=None, kernel_fns=None):
    dist = as_dist(dist, "make_prefill_step")

    def prefill_step(params, batch):
        return model_lib.prefill(cfg, params, batch, kernel_fns, dist=dist)
    return prefill_step


def make_decode_step(cfg, dist=None, kernel_fns=None):
    dist = as_dist(dist, "make_decode_step")

    def decode(params, cache, token, pos):
        return model_lib.decode_step(cfg, params, cache, token, pos,
                                     kernel_fns, dist=dist)
    return decode


def serve_step(cfg, params, cache, token, pos, dist=None):
    """One new token against an existing cache (the reference's
    ``decode_*`` / ``long_*`` dry-run entry point)."""
    dist = as_dist(dist, "serve_step")
    return model_lib.decode_step(cfg, params, cache, token, pos, dist=dist)
