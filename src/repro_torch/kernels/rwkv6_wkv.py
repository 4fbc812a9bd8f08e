"""RWKV-6 wkv recurrence: the wrapper of the hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/rwkv6_wkv.py``
(``wkv_chunked``, body ``_kernel``). The kernel (csrc/rwkv6_wkv.cu)
computes the recurrence of ``ref.wkv_ref`` (the model's ``wkv_scan``)
token by token, not in the TPU kernel's chunked form, whose
exp(-cumulative log-decay) overflows float32 for strong decays; see the
note at the top of the source.

``wkv`` checks what the kernel takes (contiguous CUDA tensors: r, k, v,
w (B,T,H,dh) and u (H,dh) of one dtype, float32 or bfloat16; state
(B,H,dh,dh) float32; dh in {8, 16, 32, 64}; any T >= 0), allocates
y and the final state with ``torch.empty`` and launches on the current
CUDA stream. ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: number of times the kernel has been launched (incremented only where
#: it is launched)
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def wkv(r, k, v, w, u, state):
    """r,k,v,w: (B,T,H,dh); u: (H,dh); state: (B,H,dh,dh) float32.
    Returns (y (B,T,H,dh) in r's dtype, final state float32)."""
    global LAUNCHES
    if not (isinstance(r, torch.Tensor) and r.is_cuda):
        raise ValueError("wkv runs on CUDA tensors only; ops.wkv takes "
                         "CPU tensors to the plain version")
    if r.dim() != 4:
        raise ValueError(f"wkv: r must be (B, T, H, dh), got "
                         f"{tuple(r.shape)}")
    B, T, H, dh = r.shape
    if r.dtype not in DTYPES:
        raise TypeError(f"wkv: takes {list(DTYPES)}, got {r.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"wkv: head dim must be one of {HEAD_DIMS}, "
                         f"got {dh}")
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _build.check("wkv", name, t, r.dtype, (B, T, H, dh), dev)
    _build.check("wkv", "u", u, r.dtype, (H, dh), dev)
    _build.check("wkv", "state", state, torch.float32, (B, H, dh, dh), dev)
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    fn = _build.function("rwkv6_wkv", "rwkv6_wkv_fwd", _ARGTYPES)
    _build.launch("rwkv6_wkv", fn, dev, r.data_ptr(), k.data_ptr(),
                  v.data_ptr(), w.data_ptr(), u.data_ptr(),
                  state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                  DTYPES[r.dtype], B, T, H, dh)
    LAUNCHES += 1
    return y, s_out
