"""Mixture-of-Experts FFN with sort-based capacity dispatch
(counterpart of ``repro/models/moe.py``), the single-device path.

Token-choice top-k routing with softmax-renormalised gates, a capacity
clamp (``capacity_factor`` over the mean load) and the Switch
load-balancing aux loss. The reference computes all of it outside any
Pallas kernel (XLA compiles it from ``jnp``); so does the port, with
the expert products as batched matmuls (``torch.bmm``).

Where the two frameworks' primitives differ, the port takes the
reference's semantics:
  * ``jax.lax.top_k`` takes the lower expert index on a tie;
    ``torch.topk`` promises nothing, so the gates come from a stable
    descending sort;
  * the dispatch sort is stable (``jnp.argsort(stable=True)``);
  * the combine ``.at[sorted_t].add(contrib)`` adds each token's K
    contributions in ``x.dtype``, in sorted (ascending expert) order,
    starting from zero. On the card ``index_add_`` would add them with
    atomics in no fixed order, so the port adds them one after another
    in that order instead: the result is the same from run to run.

Capacity comes from the token count of the call (B * T): in the
batcher's decode the empty slots' tokens compete for it, as in the
reference. The distributed path (``moe_apply_dist``, ``DistContext``,
``ep_mode``, ``moe_param_specs``) comes with the distributed slice
(ROADMAP Queue 1 item 13f).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_dense


def moe_init(gen, cfg, dtype):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    dev = gen.device

    def normal(*shape, scale):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    return {
        "router": init_dense(gen, d, E, torch.float32),
        "w_gate": normal(E, d, f, scale=d ** -0.5),
        "w_up": normal(E, d, f, scale=d ** -0.5),
        "w_down": normal(E, f, d, scale=f ** -0.5),
    }


def _top_k_gates(logits, k):
    """(S, E) float32 -> (gates (S,k), idx (S,k), me (E,), ce (E,)):
    the top k router probabilities renormalised, their experts (the
    lower index first on a tie, as ``jax.lax.top_k``), the mean router
    probability and the top-1 dispatch fraction of each expert."""
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :k], order[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = logits.shape[-1]
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    return gates, idx, me, ce


def _aux_loss(me, ce):
    return me.shape[-1] * torch.sum(me * ce)


def _dispatch_compute_combine(x, gates, idx, w_gate, w_up, w_down, e_lo,
                              n_local, capacity):
    """Sort-based dispatch of (S, d) tokens to the ``n_local`` experts
    [e_lo, e_lo + n_local), the expert FFN, the weighted combine. A
    token past its expert's ``capacity`` is dropped (contributes 0)."""
    S, d = x.shape
    K = idx.shape[1]
    dev = x.device
    flat_e = idx.reshape(-1)                              # (S*K,)
    flat_w = gates.reshape(-1)
    flat_t = torch.arange(S, device=dev).repeat_interleave(K)

    local = (flat_e >= e_lo) & (flat_e < e_lo + n_local)
    rel_e = torch.where(local, flat_e - e_lo, n_local)   # overflow bucket
    order = torch.sort(rel_e, stable=True).indices
    sorted_e, sorted_t, sorted_w = rel_e[order], flat_t[order], flat_w[order]

    counts = torch.zeros(n_local + 1, dtype=torch.long, device=dev) \
        .scatter_add_(0, sorted_e, torch.ones_like(sorted_e))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(S * K, device=dev) - offsets[sorted_e]
    keep = (sorted_e < n_local) & (pos < capacity)

    slot = torch.where(keep, sorted_e * capacity + pos, n_local * capacity)
    buf = torch.zeros((n_local * capacity + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = torch.where(keep[:, None], x[sorted_t], 0.0)
    buf = buf[:-1].reshape(n_local, capacity, d)

    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    y_buf = torch.bmm(h, w_down).reshape(-1, d)

    w = sorted_w[:, None].to(x.dtype)
    contrib = torch.where(keep[:, None],
                          y_buf[slot.clamp(max=y_buf.shape[0] - 1)] * w, 0.0)
    # the reference's scatter-add, in its order: token t's contributions
    # sit in sorted order at the positions of its K entries, which the
    # stable sort ranks by expert; add them one after another from zero
    rank = torch.empty_like(order)
    rank[order] = torch.arange(S * K, device=dev)
    rank = torch.sort(rank.reshape(S, K), dim=1).values   # (S, K)
    y = torch.zeros((S, d), dtype=x.dtype, device=dev)
    for j in range(K):
        y = y + contrib[rank[:, j]]
    return y


def _capacity(cfg, n_tokens, n_experts):
    c = int(n_tokens * cfg.top_k / n_experts * cfg.capacity_factor) + 1
    return -(-c // 8) * 8  # round up to 8


def moe_apply_pure(p, cfg, x):
    """Single-device MoE. x: (B,T,d). Returns (y (B,T,d), aux loss)."""
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    logits = xf.float() @ p["router"]
    gates, idx, me, ce = _top_k_gates(logits, cfg.top_k)
    cap = _capacity(cfg, B * T, cfg.n_experts)
    y = _dispatch_compute_combine(xf, gates, idx, p["w_gate"], p["w_up"],
                                  p["w_down"], 0, cfg.n_experts, cap)
    return y.reshape(B, T, d), _aux_loss(me, ce)


def moe_apply(p, cfg, x, dist=None):
    """``moe_apply_pure``; a distributed context is refused until the
    distributed slice ports ``moe_apply_dist``."""
    if dist is not None:
        raise NotImplementedError(
            "moe_apply: the distributed MoE (moe_apply_dist) is not ported "
            "yet (ROADMAP Queue 1 item 13f)")
    return moe_apply_pure(p, cfg, x)
