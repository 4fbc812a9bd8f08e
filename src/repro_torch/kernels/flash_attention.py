"""Flash attention: the wrapper of the hand-written CUDA kernels.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``, body ``_kernel``). The kernels
(csrc/flash_attention.cu) compute what ``ref.attention_ref`` (the
model's ``chunked_attention``) computes, for any T and S; see the note
at the top of the source for their design and what bounds them on an
H100. Two variants:

* ``"wgmma"``: tensor cores (wgmma) fed by TMA copies, for bfloat16
  at (dq, dv) in ``WGMMA_SHAPES``: (64, 64), (128, 128) and MLA's q/k
  of 96 with v of 64 (minicpm3-4b's prefill);
* ``"cuda_core"``: float32 FMAs on the CUDA cores, for float32 (whose
  callers need full float32 products) and bfloat16 at any other head
  dims.

``variant(dtype, dq, dv)`` picks one from the inputs' dtype and head
dims, and nothing else picks. ``flash_attention`` checks what the
kernels take (contiguous, 16-byte aligned CUDA float32 or bfloat16
tensors of one dtype, q (B,T,H,dq), k (B,S,H,dq) and v (B,S,H,dv) with
8 <= dq, dv <= 128, both multiples of 8), allocates the output
(B,T,H,dv) with ``torch.empty`` and launches on the current CUDA
stream. ``LAUNCHES`` counts launches,
``VARIANT_LAUNCHES`` counts them by variant.

Training: ``flash_attention_lse`` is the same launch, writing each row's
log-sum-exp of its scaled scores beside the output (float32 (B,H,T));
``flash_attention_bwd`` takes it back with the output and its gradient
and returns dq, dk, dv from a hand-written backward: three kernels a
call (a pass for D = rowsum(dO * O), a dK/dV kernel a key tile, a dQ
kernel a query tile), each output written by one block, no atomics, so
two calls give the same bits. ``bwd_variant(dtype, dq, dv)`` picks its
variant, and nothing else picks:

* ``"wgmma"``: bfloat16 at (dq, dv) in ``WGMMA_BWD_SHAPES``, (64, 64)
  and (128, 128), every product on wgmma (bf16 operands, float32 sums)
  fed by TMA;
* ``"cuda_core"``: float32 FMAs, for float32 (the float32 gradient
  check needs full float32 products) and every other head dim, MLA's
  (96, 64) among them: its backward on wgmma is still to come, and it
  takes the wgmma forward's log-sum-exp as it takes its own.

Seven 64 x 64 x d products a visible tile pair (dK/dV: S^T, dV, dP^T,
dK; dQ: S, dP, dQ) where FlashAttention-2/3 do five with an atomic dQ:
recomputing S and dP in the dQ kernel is the price of one writer an
output. Measured by ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at
700 W, at (2, 4096, 32, 128) bf16 causal: 2.82 ms a call through
wgmma (4.1x its bound, 1.87x SDPA's backward), 40.61 ms through the
CUDA cores (PERF.md). The reference has no backward
kernel: its Pallas kernel cannot be differentiated. ``BWD_LAUNCHES``
counts the backward's calls, ``BWD_VARIANT_LAUNCHES`` by variant.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (dq, dv) of bfloat16 inputs the wgmma forward takes, and its backward
WGMMA_SHAPES = ((64, 64), (128, 128), (96, 64))
WGMMA_BWD_SHAPES = ((64, 64), (128, 128))

#: number of times a kernel has been launched (incremented only where
#: one is launched), in all and by variant
LAUNCHES = 0
VARIANT_LAUNCHES = {"wgmma": 0, "cuda_core": 0}
#: calls of the backward (each launches its three kernels), in all and
#: by variant
BWD_LAUNCHES = 0
BWD_VARIANT_LAUNCHES = {"wgmma": 0, "cuda_core": 0}

_ENTRIES = {
    "cuda_core": ("flash_attention_fwd", [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]),
    "wgmma": ("flash_attention_wgmma_fwd", [ctypes.c_void_p] * 5
              + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]),
}
_BWD_ENTRIES = {
    "cuda_core": ("flash_attention_bwd", [ctypes.c_void_p] * 10
                  + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]),
    "wgmma": ("flash_attention_wgmma_bwd", [ctypes.c_void_p] * 10
              + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]),
}


def variant(dtype, dq, dv) -> str:
    """The kernel variant for inputs of ``dtype`` with head dims ``dq``
    (q, k) and ``dv`` (v): "wgmma" for bfloat16 at (dq, dv) in
    WGMMA_SHAPES, else "cuda_core"."""
    return _pick(dtype, dq, dv, WGMMA_SHAPES)


def bwd_variant(dtype, dq, dv) -> str:
    """The backward's variant for inputs of ``dtype`` with head dims
    ``dq`` and ``dv``: "wgmma" for bfloat16 at (dq, dv) in
    WGMMA_BWD_SHAPES, else "cuda_core"."""
    return _pick(dtype, dq, dv, WGMMA_BWD_SHAPES)


def _pick(dtype, dq, dv, shapes) -> str:
    return ("wgmma" if dtype == torch.bfloat16 and (dq, dv) in shapes
            else "cuda_core")


def flash_attention(q, k, v, *, causal=True, swa_window=0):
    """q: (B,T,H,dq), k: (B,S,H,dq), v: (B,S,H,dv) -> (B,T,H,dv) in q's
    dtype; masks as ``ref.attention_ref``; the variant
    ``variant(q.dtype, dq, dv)``."""
    _check(q, k, v)
    return _launch(variant(q.dtype, q.shape[-1], v.shape[-1]), q, k, v,
                   causal, swa_window)


def flash_attention_lse(q, k, v, *, causal=True, swa_window=0):
    """``flash_attention`` that also returns each row's log-sum-exp of
    its scaled scores, float32 (B, H, T): the forward of a training
    step, for ``flash_attention_bwd``."""
    _check(q, k, v)
    B, T, H, _ = q.shape
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    out = _launch(variant(q.dtype, q.shape[-1], v.shape[-1]), q, k, v,
                  causal, swa_window, lse)
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True,
                        swa_window=0):
    """The gradients (dq, dk, dv), like q, k, v, of the attention
    ``out = flash_attention(q, k, v)`` given ``lse`` from
    ``flash_attention_lse`` and ``dout``, the gradient of ``out``; the
    variant ``bwd_variant(q.dtype, dq, dv)``."""
    _check(q, k, v)
    return _launch_bwd(bwd_variant(q.dtype, q.shape[-1], v.shape[-1]), q,
                       k, v, out, lse, dout, causal, swa_window)


def _flash_attention_bwd_variant(q, k, v, out, lse, dout, name, *,
                                 causal=True, swa_window=0):
    """``flash_attention_bwd`` through the variant ``name`` whatever the
    inputs would pick (it must take them): for timing one design against
    the other on the same inputs."""
    _check(q, k, v)
    _check_variant(name, q.dtype, q.shape[-1], v.shape[-1], bwd=True)
    return _launch_bwd(name, q, k, v, out, lse, dout, causal, swa_window)


def _flash_attention_variant(q, k, v, name, *, causal=True, swa_window=0):
    """``flash_attention`` through the variant ``name`` whatever the
    inputs would pick (it must take them): for timing one variant
    against the other on the same inputs."""
    _check(q, k, v)
    _check_variant(name, q.dtype, q.shape[-1], v.shape[-1])
    return _launch(name, q, k, v, causal, swa_window)


def _check_variant(name, dtype, dq, dv, bwd=False):
    """Raise unless the variant ``name`` of the forward (or, with
    ``bwd``, the backward) takes ``dtype`` at (dq, dv)."""
    if name not in _ENTRIES:
        raise ValueError(f"flash_attention: no variant {name!r}")
    shapes = WGMMA_BWD_SHAPES if bwd else WGMMA_SHAPES
    if name == "wgmma" and _pick(dtype, dq, dv, shapes) != "wgmma":
        raise ValueError(f"flash_attention: the wgmma "
                         f"{'backward' if bwd else 'variant'} takes "
                         f"bfloat16 at (dq, dv) in {shapes}, got {dtype} "
                         f"at ({dq}, {dv})")


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
    S = k.shape[1] if k.dim() == 4 else -1
    dv = v.shape[-1] if isinstance(v, torch.Tensor) and v.dim() == 4 else d
    for name, n in (("q/k", d), ("v", dv)):
        if not (8 <= n <= MAX_HEAD_DIM and n % 8 == 0):
            raise ValueError(f"flash_attention: the head dim of {name} "
                             f"must be a multiple of 8 in "
                             f"8..{MAX_HEAD_DIM}, got {n}")
    dev = q.device
    _build.check("flash_attention", "q", q, q.dtype, (B, T, H, d), dev)
    _build.check("flash_attention", "k", k, q.dtype, (B, S, H, d), dev)
    _build.check("flash_attention", "v", v, q.dtype, (B, S, H, dv), dev)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned (the kernels load 16 bytes at a time)")


def _launch(name, q, k, v, causal, swa_window, lse=None):
    global LAUNCHES
    B, T, H, d = q.shape
    S, dv = k.shape[1], v.shape[-1]
    out = torch.empty((B, T, H, dv), dtype=q.dtype, device=q.device)
    lse_ptr = None if lse is None else lse.data_ptr()
    symbol, argtypes = _ENTRIES[name]
    fn = _build.function("flash_attention", symbol, argtypes)
    # the CUDA-core entry takes the dtype; the wgmma one is bfloat16
    dtype = (DTYPES[q.dtype],) if name == "cuda_core" else ()
    _build.launch("flash_attention", fn, q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
                  *dtype, B, T, S, H, d, dv, int(bool(causal)),
                  int(swa_window), d ** -0.5)
    LAUNCHES += 1
    VARIANT_LAUNCHES[name] += 1
    return out


def _launch_bwd(name, q, k, v, out, lse, dout, causal, swa_window):
    global BWD_LAUNCHES
    B, T, H, d = q.shape
    S, dv = k.shape[1], v.shape[-1]
    dev = q.device
    _build.check("flash_attention_bwd", "out", out, q.dtype, (B, T, H, dv),
                 dev)
    _build.check("flash_attention_bwd", "dout", dout, q.dtype,
                 (B, T, H, dv), dev)
    _build.check("flash_attention_bwd", "lse", lse, torch.float32,
                 (B, H, T), dev)
    if any(t.data_ptr() % 16 for t in (out, dout)):
        raise ValueError("flash_attention_bwd: out and dout must be "
                         "16-byte aligned")
    dq, dk, dv_ = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    symbol, argtypes = _BWD_ENTRIES[name]
    fn = _build.function("flash_attention", symbol, argtypes)
    # the CUDA-core entry takes the dtype and dv; the wgmma one has dv = d
    dims = (d, dv) if name == "cuda_core" else (d,)
    dtype = (DTYPES[q.dtype],) if name == "cuda_core" else ()
    _build.launch("flash_attention_bwd", fn, dev, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv_.data_ptr(), *dtype, B, T,
                  S, H, *dims, int(bool(causal)), int(swa_window), d ** -0.5)
    BWD_LAUNCHES += 1
    BWD_VARIANT_LAUNCHES[name] += 1
    return dq, dk, dv_
