"""Carry scenario batches and simulator state across to the reference.

The tick-level parity tests step the port and the JAX reference from
ONE state. These helpers turn the reference's ``Scenario``/``SimState``
leaves — fetched to the host as numpy arrays (``jax.device_get``) — into
the port's tensors and back. They go by field name alone: any object
whose fields carry the port's names converts, so nothing here imports
the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import gating
from repro_torch.core.simulator import Scenario, SimState


def _tensor(x, device):
    a = np.asarray(x)
    if a.dtype == np.uint32:           # threefry key words
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a), device=device)


def scenario_from_numpy(scen, device="cpu") -> Scenario:
    """A batched ``Scenario`` (leaves (B,)) with the port's field names
    -> the port's ``Scenario`` of tensors on ``device``."""
    return Scenario(*(_tensor(getattr(scen, f), device)
                      for f in Scenario._fields))


def state_from_numpy(state, device="cpu") -> SimState:
    """A batched ``SimState`` (leaves with a leading B axis; the gate
    and fault carries as ``GateState``/``FaultState``-shaped objects,
    ``acc`` a mapping) -> the port's ``SimState`` on ``device``."""
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
            leaves[f] = {k: _tensor(a, device).to(torch.float32)
                         for k, a in v.items()}
        else:
            leaves[f] = _tensor(v, device)
    return SimState(**leaves)


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
