"""Device dispatch for the port's kernels (counterpart of
``repro/kernels/ops.py``).

A kernel entry point looks at the device of the tensors it is given: a
CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain PyTorch version. There is no fallback
from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels import lcdc_switch as _sw
from repro_torch.kernels import ref as _ref


def switch_step(queues, stage, arrivals, draining=None, *, valid=None,
                cap=20.0, hi=0.75, lo=0.22, serve_rate=1.0):
    """One LC/DC switch tick (the simulator's datapath): the CUDA kernel
    for CUDA tensors, ``ref.switch_step_ref`` for CPU tensors. See
    ``ref.switch_step_ref`` for the argument and return contract."""
    kw = dict(valid=valid, cap=cap, hi=hi, lo=lo, serve_rate=serve_rate)
    if queues.is_cuda:
        return _sw.switch_step(queues, stage, arrivals, draining, **kw)
    if queues.device.type == "cpu":
        return _ref.switch_step_ref(queues, stage, arrivals, draining, **kw)
    raise ValueError(f"switch_step: no kernel for device {queues.device}")
