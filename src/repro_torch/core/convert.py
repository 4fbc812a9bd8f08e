"""Carry scenario batches, simulator state, model parameters and
caches across from the reference.

The parity tests run the port and the JAX reference from ONE state.
These helpers turn the reference's trees — fetched to the host as numpy
arrays (``jax.device_get``) — into the port's tensors (and simulator
state back). They go by field and key name alone, so nothing here
imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import gating
from repro_torch.core.simulator import (ACC_SHAPES, Scenario, SimState,
                                        _fold_flat)


def _tensor(x, device):
    a = np.asarray(x)
    if a.dtype == np.uint32:           # threefry key words
        a = a.astype(np.int64)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(np.array(a).view(np.uint16)) \
            .view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def scenario_from_numpy(scen, device="cpu") -> Scenario:
    """A batched ``Scenario`` (leaves (B,)) with the port's field names
    -> the port's ``Scenario`` of tensors on ``device``."""
    return Scenario(*(_tensor(getattr(scen, f), device)
                      for f in Scenario._fields))


def state_from_numpy(state, device="cpu") -> SimState:
    """A batched ``SimState`` (leaves with a leading B axis; the gate
    and fault carries as ``GateState``/``FaultState``-shaped objects,
    ``acc`` a mapping) -> the port's ``SimState`` on ``device``. Every
    leaf keeps its type, so a state of the reference's x64 mode (float64
    queues and accumulators, float32 flow table) stays one."""
    def tier(obj, cls):
        return cls(*(_tensor(getattr(obj, f), device) for f in cls._fields))

    leaves = {}
    for f in SimState._fields:
        v = getattr(state, f)
        if f in ("rsw_gate", "csw_gate"):
            leaves[f] = tier(v, gating.GateState)
        elif f in ("rsw_fault", "csw_fault"):
            leaves[f] = tier(v, gating.FaultState)
        elif f == "acc":
            leaves[f] = {k: _tensor(a, device) for k, a in v.items()}
        else:
            leaves[f] = _tensor(v, device)
    return SimState(**leaves)


def fold_from_numpy(fold, device="cpu") -> tuple:
    """The reference's device fold ``(sum, comp)``, two mappings of
    accumulator name -> (B, ...) array -> the port's flat (B, N) Kahan
    pair of the same type (float32, or float64 under x64)."""
    return tuple(_fold_flat({k: _tensor(part[k], device)
                             for k in ACC_SHAPES}) for part in fold)


def state_to_numpy(state: SimState) -> dict:
    """The port's ``SimState`` -> a flat {leaf path: numpy array} dict
    (``"rsw_gate.stage"``, ``"acc.injected"``, ...); keys come back as
    uint32 words, as the reference holds them."""
    out = {}
    for f in SimState._fields:
        v = getattr(state, f)
        if isinstance(v, dict):
            for k, a in v.items():
                out[f"{f}.{k}"] = a.cpu().numpy()
        elif isinstance(v, tuple):
            for g in v._fields:
                out[f"{f}.{g}"] = getattr(v, g).cpu().numpy()
        else:
            a = v.cpu().numpy()
            out[f] = a.astype(np.uint32) if f == "key" else a
    return out


def _tree(tree, device, index=None):
    """A nested dict of arrays -> the same dict of tensors; with
    ``index``, of each leaf's slice ``[index]`` (one stacked layer)."""
    if isinstance(tree, dict):
        return {k: _tree(v, device, index) for k, v in tree.items()}
    return _tensor(tree if index is None else np.asarray(tree)[index],
                   device)


def _layers(tree, device) -> list:
    """The reference's layer stack (``prefix<i>`` layers, then
    ``stack["sub<j>"]`` with a leading ``n_scan`` axis, the vmap-ed
    init's layout) -> one dict per layer, in model order."""
    n_prefix = sum(1 for k in tree if k.startswith("prefix"))
    layers = [_tree(tree[f"prefix{i}"], device) for i in range(n_prefix)]
    stack = tree["stack"]
    period = [stack[f"sub{j}"] for j in range(len(stack))]
    for i in range(_leading(stack)):
        layers += [_tree(sub, device, i) for sub in period]
    return layers


def _leading(tree):
    """The leading-axis length of the first leaf of a nested dict (None
    for a dict without leaves)."""
    for v in tree.values():
        n = _leading(v) if isinstance(v, dict) else len(v)
        if n is not None:
            return n
    return None


def params_from_numpy(params, device="cpu") -> dict:
    """``repro.models.model.init_params`` output (leaves as numpy
    arrays) -> the port's parameters: ``embed``, ``final_norm``,
    ``head`` (if untied) and ``layers``, one dict per layer."""
    out = {k: _tensor(params[k], device)
           for k in ("embed", "final_norm", "head") if k in params}
    out["layers"] = _layers(params, device)
    return out


def cache_from_numpy(cache, device="cpu") -> dict:
    """A reference cache (``init_cache`` or ``prefill`` output, leaves
    as numpy arrays, layer leaves stacked on a leading axis) -> the
    port's cache: ``pos_offset`` and ``layers``, one dict per layer with
    the batch at axis 0."""
    return {"pos_offset": _tensor(cache["pos_offset"], device),
            "layers": _layers(cache, device)}


def opt_state_from_numpy(opt, params_like, device="cpu") -> dict:
    """The reference's optimizer state (leaves as numpy arrays) -> the
    port's, on ``device``. AdamW (``step``, ``m``, ``v``): the moments
    have the parameters' stacked layout and are un-stacked as
    ``params_from_numpy`` does, one dict per layer, and must match
    ``params_like`` (the port's parameters) leaf for leaf in shape.
    Adafactor (``step``, ``v`` of ``vr``/``vc`` or ``v``): kept in the
    reference's stacked layout, which is how the port's adafactor holds
    it (its statistics span a stacked leaf's layers)."""
    from repro_torch.core.tree import paths
    step = _tensor(opt["step"], device)
    if "m" not in opt:
        return {"step": step, "v": _tree(opt["v"], device)}
    m, v = (params_from_numpy(opt[k], device) for k in ("m", "v"))
    want = [tuple(p.shape) for _, p in paths(params_like)]
    for name, tree in (("m", m), ("v", v)):
        got = [tuple(t.shape) for _, t in paths(tree)]
        if got != want:
            raise ValueError(f"opt_state_from_numpy: the {name} moments "
                             f"do not match the parameters' layout")
    return {"step": step, "m": m, "v": v}
