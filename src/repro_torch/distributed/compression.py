"""Gradient compression for the data-parallel all-reduce (counterpart of
``repro/distributed/compression.py``): per-tensor symmetric int8 with
error feedback, the residual carried across steps so the compression
error does not accumulate (EF-SGD). One process, no collective: it
maps a gradient tree to the tree the all-reduce would carry.

The reference's operations in its order, in float32: ``round`` is
round-half-to-even in both frameworks, and the scale is ``amax /
127`` (a float32 division), so ``q`` and ``scale`` are the reference's
to the bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, tree_map, unflatten


def ef_state_init(params):
    """A float32 zero residual of each leaf's shape, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize_int8(x):
    """Per-tensor symmetric int8. Returns (q int8, scale float32 0-d)."""
    amax = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_grads(grads, ef_state):
    """Error-feedback compression: g' = Q(g + e), e' = (g + e) - g'.
    Returns (g' in each gradient's dtype, e' float32), both in the
    gradients' structure."""
    def one(g, e):
        t = g.to(torch.float32) + e
        q, s = quantize_int8(t)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), t - deq

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(ef_state))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
