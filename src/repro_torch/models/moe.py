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
reference.

The distributed path (``moe_apply_dist``) runs on every rank of a
('data', 'model') mesh what the reference's ``shard_map`` body runs on
each device, with one of two expert layouts (``ep_mode``):
  * ``ep``: experts over the model axis (E % model == 0), their d_ff
    FSDP-sharded over the data axes and gathered at use; a rank
    computes its data block's tokens through its experts;
  * ``tp``: d_ff over the model axis, d_model FSDP over 'data'; every
    expert on every rank, a part of d_ff each.
Either way the combine is a ``psum`` over 'model', or with
``cfg.moe_combine == "psum_scatter"`` a reduce-scatter into a d-sharded
output. Routing (router, gates, top-k, the aux statistics) runs on the
rank's tokens as they are, replicated over 'model'; the gates and
tokens enter the expert part through ``copy_to`` (their gradient is
summed over 'model', where each rank's experts see a part). The router
statistics are averaged over the data axes before the aux loss, so the
loss equals one device's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.models.layers import init_dense


@dataclass(frozen=True)
class DistContext:
    """Where a distributed step runs: ``mesh`` a
    ``torch.distributed.device_mesh.DeviceMesh`` with axes ('data',
    'model') or ('pod', 'data', 'model') (``launch.mesh``), a
    shape-only mesh (any object whose ``.shape`` maps axis names to
    sizes: specs only, no ranks), or None (one device)."""
    mesh: object = None
    data_axes: tuple = ("data",)     # ('pod', 'data') when multi-pod
    model_axis: str = "model"

    @property
    def model_size(self) -> int:
        return C.axis_sizes(self.mesh)[self.model_axis] if self.mesh \
            is not None else 1

    @property
    def data_size(self) -> int:
        if self.mesh is None:
            return 1
        sizes = C.axis_sizes(self.mesh)
        n = 1
        for a in self.data_axes:
            n *= sizes[a]
        return n


def as_dist(dist, what="dist"):
    """None for one device (None, or a ``DistContext`` with no mesh),
    else the ``DistContext``; another object raises ``TypeError``."""
    if dist is None:
        return None
    if not isinstance(dist, DistContext):
        raise TypeError(f"{what}: expected a DistContext or None, got "
                        f"{type(dist).__name__}")
    return dist if dist.mesh is not None else None


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
    # jax.nn.one_hot's compare with an iota (F.one_hot's ops differ by
    # device, and the dry run's count must not)
    top1 = idx[:, :1] == torch.arange(E, device=idx.device)
    ce = top1.float().mean(dim=0)
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


def ep_mode(cfg, dist: DistContext) -> str:
    if dist.model_size > 1 and cfg.expert_parallel and \
            cfg.n_experts % dist.model_size == 0:
        return "ep"
    return "tp"


def _fsdp_axes(cfg, dist):
    """The expert d_ff's FSDP axes: the (composite) data axes when they
    divide it, else 'data' alone."""
    return C.spec_entry(dist.data_axes) \
        if cfg.d_expert % dist.data_size == 0 else "data"


def moe_param_specs(cfg, dist: DistContext) -> dict:
    """The layout of ``moe_apply_dist``'s parameters: one entry a
    dimension (None, an axis or a tuple of axes), the reference's
    PartitionSpecs as tuples."""
    ma = dist.model_axis
    if ep_mode(cfg, dist) == "ep":
        fsdp = _fsdp_axes(cfg, dist)
        return {"router": (), "w_gate": (ma, None, fsdp),
                "w_up": (ma, None, fsdp), "w_down": (ma, fsdp, None)}
    return {"router": (), "w_gate": (None, "data", ma),
            "w_up": (None, "data", ma), "w_down": (None, ma, "data")}


def combine_scatters(cfg, dist: DistContext) -> bool:
    """Whether ``moe_apply_dist`` combines with ``psum_scatter`` (the
    config asks for it and d divides 'model'): its output is then the
    rank's block of d, the residual's layout under ``act_shard ==
    "dmodel"`` (``distributed.sharding.act_spec``)."""
    return cfg.moe_combine == "psum_scatter" and \
        cfg.d_model % dist.model_size == 0


def moe_apply_dist(p, cfg, x, dist: DistContext, split=True):
    """The distributed MoE on this rank. ``p``: this rank's blocks of
    the parameters (``moe_param_specs``); ``x`` (B_loc, T, d): the
    rank's block of a batch split over the data axes, or with ``split``
    False the whole batch (the reference's case of a B that does not
    divide the data axes: the tokens are replicated over them and only
    'model' shares the work). Returns (y, aux): y (B_loc, T, d) summed
    over 'model' (the ``psum`` combine), or (B_loc, T, d / model) under
    the ``psum_scatter`` combine (``combine_scatters``): this rank's
    block of d, the residual's ``"dmodel"`` block, which the model keeps
    as it is; aux the global aux loss."""
    B, T, d = x.shape
    mode = ep_mode(cfg, dist)
    m = dist.model_size
    da, ma = dist.data_axes, dist.model_axis
    E = cfg.n_experts
    specs = moe_param_specs(cfg, dist)
    w = {k: C.gather_param(p[k], dist, specs[k], keep=(ma,))
         for k in ("router", "w_gate", "w_up", "w_down")}
    if mode == "ep":
        n_local = E // m
        e_lo = C.axis_index(dist, ma) * n_local
    else:
        n_local, e_lo = E, 0
    S_loc = B * T
    xf = x.reshape(S_loc, d)
    logits = xf.float() @ w["router"]
    gates, idx, me, ce = _top_k_gates(logits, cfg.top_k)
    cap = _capacity(cfg, S_loc, E)
    y = _dispatch_compute_combine(
        C.copy_to(xf, dist, ma), C.copy_to(gates, dist, ma), idx,
        w["w_gate"], w["w_up"], w["w_down"], e_lo, n_local, cap)
    if combine_scatters(cfg, dist):
        # straight into the d-sharded residual layout (half the ring
        # traffic of an all-reduce)
        y = C.psum_scatter(y, dist, ma, 1)
    else:
        y = C.psum(y, dist, ma)
    if split:
        me = C.pmean(me, dist, da)
        ce = C.pmean(ce, dist, da)
    return y.reshape(B, T, -1), _aux_loss(me, ce)


def moe_apply(p, cfg, x, dist=None):
    """``moe_apply_pure`` on one device (``dist`` None, or a
    ``DistContext`` without a mesh: the same bits), else
    ``moe_apply_dist``."""
    dist = as_dist(dist, "moe_apply")
    if dist is None:
        return moe_apply_pure(p, cfg, x)
    return moe_apply_dist(p, cfg, x, dist)
