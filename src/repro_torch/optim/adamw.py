"""AdamW with decoupled weight decay (counterpart of
``repro/optim/adamw.py``): moments in float32, the reference's order of
operations, the update as ``(p.float() - lr * u).to(p.dtype)``.

The moments are updated in place (each step would otherwise hold two
float32 copies of them: 22 GB at qwen3-8b's 8-layer card run); the
returned state holds the same tensors. The parameters come back as new
tensors. A leaf's update runs the formula's operations in its order,
in place on two float32 scratch tensors of the leaf's size (an
operation rounds the same in place as not), where the formula written
out holds up to five: 18.8 GB for one of jamba-v0.1-52b's (16, 4096,
14336) expert leaves, more than its training step on an 80 GB card
has to spare.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, tree_map


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device),
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params)}


def adamw_update(grads, state, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """(new params, new state); ``grads`` and the moments have the
    params' structure, ``lr`` a float or a float32 scalar tensor."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(g, m, v, p):
        g = g.float()
        s = torch.mul(g, 1 - b1)                          # (1 - b1) g
        m.mul_(b1).add_(s)
        torch.mul(g, 1 - b2, out=s).mul_(g)               # (1 - b2) g g
        del g
        v.mul_(b2).add_(s)
        torch.div(v, c2, out=s).sqrt_().add_(eps)         # sqrt(v/c2) + eps
        u = torch.div(m, c1).div_(s)
        u.add_(s.copy_(p).mul_(weight_decay))             # + wd p
        return s.copy_(p).sub_(u.mul_(lr)).to(p.dtype)    # p - lr u

    new_params = tree_map(upd, grads, state["m"], state["v"], params)
    return new_params, {"step": step, "m": state["m"], "v": state["v"]}
