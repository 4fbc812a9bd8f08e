"""Flash attention: the wrapper of the hand-written CUDA kernels.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``, body ``_kernel``). The kernels
(csrc/flash_attention.cu) compute what ``ref.attention_ref`` (the
model's ``chunked_attention``) computes, for any T and S; see the note
at the top of the source for their design and what bounds them on an
H100. Two variants:

* ``"wgmma"``: tensor cores (wgmma) fed by TMA copies, for bfloat16 at
  head dims ``WGMMA_HEAD_DIMS``;
* ``"cuda_core"``: float32 FMAs on the CUDA cores, for float32 (whose
  callers need full float32 products) and bfloat16 at any other head
  dim.

``variant(dtype, d)`` picks one from the inputs' dtype and head dim,
and nothing else picks. ``flash_attention`` checks what the kernels
take (contiguous, 16-byte aligned CUDA float32 or bfloat16 tensors of
one dtype, q (B,T,H,d) and k, v (B,S,H,d) with one head dim
8 <= d <= 128, d % 8 == 0), allocates the output with ``torch.empty``
and launches on the current CUDA stream. ``LAUNCHES`` counts launches,
``VARIANT_LAUNCHES`` counts them by variant.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_HEAD_DIMS = (64, 128)

#: number of times a kernel has been launched (incremented only where
#: one is launched), in all and by variant
LAUNCHES = 0
VARIANT_LAUNCHES = {"wgmma": 0, "cuda_core": 0}

_ENTRIES = {
    "cuda_core": ("flash_attention_fwd", [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]),
    "wgmma": ("flash_attention_wgmma_fwd", [ctypes.c_void_p] * 4
              + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]),
}


def variant(dtype, d) -> str:
    """The kernel variant for inputs of ``dtype`` with head dim ``d``:
    "wgmma" for bfloat16 at d in WGMMA_HEAD_DIMS, else "cuda_core"."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_core"


def flash_attention(q, k, v, *, causal=True, swa_window=0):
    """q: (B,T,H,d), k/v: (B,S,H,d) -> (B,T,H,d) in q's dtype; masks as
    ``ref.attention_ref``; the variant ``variant(q.dtype, d)``."""
    _check(q, k, v)
    return _launch(variant(q.dtype, q.shape[-1]), q, k, v, causal,
                   swa_window)


def _flash_attention_variant(q, k, v, name, *, causal=True, swa_window=0):
    """``flash_attention`` through the variant ``name`` whatever the
    inputs would pick (it must take them): for timing one variant
    against the other on the same inputs."""
    _check(q, k, v)
    if name == "wgmma" and variant(q.dtype, q.shape[-1]) != "wgmma":
        raise ValueError(f"flash_attention: the wgmma variant takes "
                         f"bfloat16 at d in {WGMMA_HEAD_DIMS}, got "
                         f"{q.dtype} at d = {q.shape[-1]}")
    if name not in _ENTRIES:
        raise ValueError(f"flash_attention: no variant {name!r}")
    return _launch(name, q, k, v, causal, swa_window)


def _check(q, k, v):
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
                         "aligned (the kernels load 16 bytes at a time)")


def _launch(name, q, k, v, causal, swa_window):
    global LAUNCHES
    B, T, H, d = q.shape
    S = k.shape[1]
    out = torch.empty_like(q)
    symbol, argtypes = _ENTRIES[name]
    fn = _build.function("flash_attention", symbol, argtypes)
    dtype = (DTYPES[q.dtype],) if name == "cuda_core" else ()
    _build.launch("flash_attention", fn, q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), *dtype, B, T,
                  S, H, d, int(bool(causal)), int(swa_window), d ** -0.5)
    LAUNCHES += 1
    VARIANT_LAUNCHES[name] += 1
    return out
