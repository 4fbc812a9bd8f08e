"""Train, prefill and decode step factories (counterpart of
``repro/train/steps.py``).

``make_train_step`` closes over (cfg, optimizer) and returns
``train_step(params, opt_state, batch, step) -> (params, opt_state,
metrics)``: the gradients from plain ``torch.autograd`` over
``models.model.train_loss`` (through the CUDA kernels' backward kernels
with ``kernel_fns = ops.model_kernel_fns()`` on the card), microbatches
accumulated in the parameters' dtype in the reference's order, the
optimizer update at the step's ``cosine_warmup`` rate. The reference
jits it; here it runs eagerly. Distributed contexts (``dist``) wait for
the distributed slice (ROADMAP Queue 1 item 13f).
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, paths, tree_map, unflatten
from repro_torch.models import model as model_lib
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedule import cosine_warmup


def _refuse(dist, what):
    if dist is not None:
        raise NotImplementedError(
            f"{what}: a distributed context is not ported yet (ROADMAP "
            "Queue 1 item 13f)")


def _loss_and_grads(cfg, params, batch, kernel_fns):
    """(loss, metrics, grads): grads in the parameters' structure and
    dtypes, zeros for a leaf the loss does not reach."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = leaves(live)
    loss, metrics = model_lib.train_loss(cfg, live, batch, kernel_fns)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, flat)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def make_train_step(cfg, dist=None, kernel_fns=None, peak_lr=3e-4,
                    warmup=100):
    _refuse(dist, "make_train_step")
    _, opt_update = make_optimizer(cfg)

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
                loss, m, g = _loss_and_grads(cfg, params, mb, kernel_fns)
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
                                                   kernel_fns)
        dev = leaves(params)[0].device
        lr = cosine_warmup(step, peak_lr=peak_lr, warmup=warmup, device=dev)
        new_params, new_opt = opt_update(grads, opt_state, params, lr)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for _, g in paths(grads)))
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(cfg, dist=None, kernel_fns=None):
    _refuse(dist, "make_prefill_step")

    def prefill_step(params, batch):
        return model_lib.prefill(cfg, params, batch, kernel_fns)
    return prefill_step


def make_decode_step(cfg, dist=None, kernel_fns=None):
    _refuse(dist, "make_decode_step")

    def decode(params, cache, token, pos):
        return model_lib.decode_step(cfg, params, cache, token, pos,
                                     kernel_fns)
    return decode


def serve_step(cfg, params, cache, token, pos, dist=None):
    """One new token against an existing cache (the reference's
    ``decode_*`` / ``long_*`` dry-run entry point)."""
    _refuse(dist, "serve_step")
    return model_lib.decode_step(cfg, params, cache, token, pos)
