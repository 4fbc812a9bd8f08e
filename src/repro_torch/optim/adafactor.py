"""Adafactor (counterpart of ``repro/optim/adafactor.py``): a factored
float32 second moment, no first moment, the RMS clip of the update.

The reference updates its parameters as they are stored: the layers of
a scanned stack are ONE leaf with a leading (n_scan,) axis. That
changes the arithmetic, and the port holds a leaf per layer, so the
update groups them back:
  * a stacked leaf (n_scan, ...) is factored over its last two dims, so
    a stacked 1-D gain (n_scan, d) is factored across the layers;
  * the RMS clip runs over the whole stacked leaf, all layers together.
With ``plan`` = ``models.model.stack_plan(cfg)``, ``groups`` gathers the
port's per-layer leaves into the reference's stacked leaves (prefix
layers and the embedding, norm and head stay single), and the state is
kept in the reference's layout (``v`` keyed like its stacked
parameters: "prefix<i>", "stack" / "sub<j>"), so it converts and
checkpoints as the reference's. Without a plan every leaf is its own
group (a plain tree of tensors).
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import get, paths, set_in, tree_map

EPS1 = 1e-30


def groups(params, plan=None):
    """[(reference path, [port paths])]: the port leaves that make one
    reference leaf, stacked along a new axis 0 when the reference path
    starts with "stack"."""
    out, stacked = [], {}
    n_prefix, period = (plan[0], plan[2]) if plan is not None else (0, 1)
    for path, _ in paths(params):
        if plan is None or path[0] != "layers":
            out.append((path, [path]))
            continue
        i, rest = path[1], path[2:]
        if i < n_prefix:
            out.append((("prefix%d" % i,) + rest, [path]))
            continue
        ref = ("stack", "sub%d" % ((i - n_prefix) % period)) + rest
        if ref not in stacked:
            stacked[ref] = []
            out.append((ref, stacked[ref]))
        stacked[ref].append(path)
    return out


def _gather(tree, ref, members):
    if ref[0] == "stack":
        return torch.stack([get(tree, p).float() for p in members])
    return get(tree, members[0]).float()


def _factored(shape):
    return len(shape) >= 2


def adafactor_init(params, plan=None):
    dev = None
    v: dict = {}
    for ref, members in groups(params, plan):
        leaf = get(params, members[0])
        dev = leaf.device
        shape = tuple(leaf.shape)
        if ref[0] == "stack":
            shape = (len(members),) + shape

        def zeros(s):
            return torch.zeros(s, dtype=torch.float32, device=leaf.device)
        if _factored(shape):
            set_in(v, ref, {"vr": zeros(shape[:-1]),
                            "vc": zeros(shape[:-2] + shape[-1:])})
        else:
            set_in(v, ref, {"v": zeros(shape)})
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "v": v}


def adafactor_update(grads, state, params, lr, *, decay=0.8, clip=1.0,
                     weight_decay=0.0, eps=1e-8, plan=None):
    """(new params, new state); ``plan`` as ``adafactor_init``'s."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    beta = 1.0 - t ** -decay
    new_params = tree_map(lambda _: None, params)   # filled below
    new_v: dict = {}
    for ref, members in groups(params, plan):
        g = _gather(grads, ref, members)
        p = _gather(params, ref, members)
        v = get(state["v"], ref)
        g2 = g * g + EPS1
        if _factored(g.shape):
            vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            rfac = torch.rsqrt(
                vr / torch.clamp(torch.mean(vr, -1, keepdim=True), min=EPS1)
                + eps)
            cfac = torch.rsqrt(vc + eps)
            u = g * rfac[..., None] * cfac[..., None, :]
            nv = {"vr": vr, "vc": vc}
        else:
            nvv = beta * v["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(nvv + eps)
            nv = {"v": nvv}
        # update clipping by RMS, over the whole (stacked) leaf
        rms = torch.sqrt(torch.mean(u * u) + EPS1)
        u = u / torch.clamp(rms / clip, min=1.0)
        if weight_decay:
            u = u + weight_decay * p
        new = p - lr * u
        dtype = get(params, members[0]).dtype
        parts = new.unbind(0) if ref[0] == "stack" else [new]
        for path, part in zip(members, parts):
            set_in(new_params, path, part.to(dtype))
        set_in(new_v, ref, nv)
    return new_params, {"step": step, "v": new_v}

