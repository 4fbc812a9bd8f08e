"""Flash attention: the wrapper of the hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``, body ``_kernel``). The kernel
(csrc/flash_attention.cu) computes what ``ref.attention_ref`` (the
model's ``chunked_attention``) computes, for any T and S; see the note
at the top of the source for its design and what bounds it on an H100.

``flash_attention`` checks what the kernel takes (contiguous, 16-byte
aligned CUDA float32 or bfloat16 tensors of one dtype, q (B,T,H,d) and
k, v (B,S,H,d) with one head dim 8 <= d <= 128, d % 8 == 0), allocates
the output with ``torch.empty`` and launches on the current CUDA
stream.
``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: number of times the kernel has been launched (incremented only where
#: it is launched)
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
    + [ctypes.c_float, ctypes.c_void_p]


def flash_attention(q, k, v, *, causal=True, swa_window=0):
    """q: (B,T,H,d), k/v: (B,S,H,d) -> (B,T,H,d) in q's dtype; masks as
    ``ref.attention_ref``."""
    global LAUNCHES
    if not (isinstance(q, torch.Tensor) and q.is_cuda):
        raise ValueError("flash_attention runs on CUDA tensors only; "
                         "ops.attention takes CPU tensors to the plain "
                         "version")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, T, H, d), got "
                         f"{tuple(q.shape)}")
    B, T, H, d = q.shape
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: takes {list(DTYPES)}, got "
                        f"{q.dtype}")
    if not (8 <= d <= MAX_HEAD_DIM and d % 8 == 0):
        raise ValueError(f"flash_attention: head dim must be a multiple "
                         f"of 8 in 8..{MAX_HEAD_DIM}, got {d}")
    S = k.shape[1] if k.dim() == 4 else -1
    dev = q.device
    _build.check("flash_attention", "q", q, q.dtype, (B, T, H, d), dev)
    _build.check("flash_attention", "k", k, q.dtype, (B, S, H, d), dev)
    _build.check("flash_attention", "v", v, q.dtype, (B, S, H, d), dev)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned (the kernel loads 16 bytes at a time)")
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention_fwd",
                         _ARGTYPES)
    _build.launch("flash_attention", fn, dev, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), DTYPES[q.dtype], B, T, S,
                  H, d, int(bool(causal)), int(swa_window), d ** -0.5)
    LAUNCHES += 1
    return out
