"""LC/DC switch datapath step: the wrapper of the hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/lcdc_switch.py``
(``switch_step``, body ``_kernel``). The kernel (csrc/lcdc_switch.cu)
runs one thread per switch row and computes exactly what
``ref.switch_step_ref`` computes; see the note at the top of the source
for what bounds it on an H100 (launch latency, not bytes) and how the
design follows from that.

``switch_step`` takes the reference's arguments, checks what the
kernel accepts (CUDA float32/int32/bool tensors, contiguous rows,
1 <= L <= 16 ports, K in {1, 2} components), allocates the 8 outputs
with ``torch.empty`` and launches on the current CUDA stream. The
per-switch ``cap``/``hi``/``lo`` become per-row columns and a (S,)
``valid`` mask is broadcast to the kernel's per-link (S, L) operand.
``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_LINKS = 16

#: number of times the kernel has been launched (incremented only where
#: it is launched)
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p] * 9


def _check(name, t, dtype, shape, device):
    _build.check("switch_step", name, t, dtype, shape, device)


def _column(v, S, device):
    """Scalar or (S,) float32 knob -> contiguous (S,) device column."""
    if isinstance(v, torch.Tensor):
        if v.dim() == 0:
            return v.to(device=device, dtype=torch.float32).expand(S) \
                .contiguous()
        _check("per-switch knob", v, torch.float32, (S,), device)
        return v
    return torch.full((S,), float(v), dtype=torch.float32, device=device)


def switch_step(queues, stage, arrivals, draining=None, *, valid=None,
                cap=20.0, hi=0.75, lo=0.22, serve_rate=1.0):
    """One switch tick on the card; same contract as
    ``ref.switch_step_ref``: returns (new_queues, served, hi_trig,
    lo_trig, dropped, enq_wait, occ_m1, occ_m2)."""
    global LAUNCHES
    if not (isinstance(queues, torch.Tensor) and queues.is_cuda):
        raise ValueError("lcdc_switch.switch_step runs on CUDA tensors "
                         "only; ops.switch_step takes CPU tensors to the "
                         "plain version")
    squeeze = queues.dim() == 2
    if squeeze:
        queues, arrivals = queues[..., None], arrivals[..., None]
    if queues.dim() != 3:
        raise ValueError(f"switch_step: queues must be (S, L, K) or "
                         f"(S, L), got {tuple(queues.shape)}")
    S, L, K = queues.shape
    dev = queues.device
    if not 1 <= L <= MAX_LINKS:
        raise ValueError(f"switch_step: the kernel takes 1..{MAX_LINKS} "
                         f"ports, got L={L}")
    if K not in (1, 2):
        raise ValueError(f"switch_step: the kernel takes K in {{1, 2}} "
                         f"components, got K={K}")
    _check("queues", queues, torch.float32, (S, L, K), dev)
    _check("stage", stage, torch.int32, (S,), dev)
    _check("arrivals", arrivals, torch.float32, (S, K), dev)
    if draining is None:
        draining = torch.zeros((S,), dtype=torch.bool, device=dev)
    _check("draining", draining, torch.bool, (S,), dev)
    if valid is None:
        valid = torch.ones((S, L), dtype=torch.bool, device=dev)
    elif valid.dim() == 1:
        _check("valid", valid, torch.bool, (S,), dev)
        valid = valid[:, None].expand(S, L).contiguous()
    _check("valid", valid, torch.bool, (S, L), dev)
    cap_c, hi_c, lo_c = (_column(v, S, dev) for v in (cap, hi, lo))

    q_out = torch.empty_like(queues)
    served = torch.empty_like(queues)
    hi_t = torch.empty((S,), dtype=torch.int32, device=dev)
    lo_t = torch.empty((S,), dtype=torch.int32, device=dev)
    drop, wait, m1, m2 = (torch.empty((S,), dtype=torch.float32,
                                      device=dev) for _ in range(4))
    fn = _build.function("lcdc_switch", "lcdc_switch_step", _ARGTYPES)
    _build.launch("lcdc_switch", fn, dev, queues.data_ptr(),
                  stage.data_ptr(), arrivals.data_ptr(), draining.data_ptr(),
                  valid.data_ptr(), cap_c.data_ptr(), hi_c.data_ptr(),
                  lo_c.data_ptr(), float(serve_rate), S, L, K,
                  q_out.data_ptr(), served.data_ptr(), hi_t.data_ptr(),
                  lo_t.data_ptr(), drop.data_ptr(), wait.data_ptr(),
                  m1.data_ptr(), m2.data_ptr())
    LAUNCHES += 1
    if squeeze:
        q_out, served = q_out[..., 0], served[..., 0]
    return q_out, served, hi_t, lo_t, drop, wait, m1, m2
