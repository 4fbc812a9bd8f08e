"""RWKV-6 wkv recurrence: the wrapper of the hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/rwkv6_wkv.py``
(``wkv_chunked``, body ``_kernel``). The kernel (csrc/rwkv6_wkv.cu)
computes the recurrence of ``ref.wkv_ref`` (the model's ``wkv_scan``)
token by token, not in the TPU kernel's chunked form, whose
exp(-cumulative log-decay) overflows float32 for strong decays; see the
note at the top of the source.

Each state column is split over G threads ("groups") and each (head,
sequence) pair's columns over C blocks ("splits"); ``plan(B, T, H)``
picks both, and nothing else picks. ``wkv`` checks what the kernel
takes (contiguous, 16-byte aligned CUDA tensors: r, k, v, w (B,T,H,dh)
and u (H,dh) of one dtype, float32 or bfloat16; state (B,H,dh,dh)
float32; dh in {8, 16, 32, 64}; any T >= 0), allocates y and the final
state with ``torch.empty`` and launches on the current CUDA stream.
``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GROUPS = (1, 2, 4, 8)        # threads per state column
SPLITS = (1, 2, 4)           # blocks per (head, sequence)
SMS = 132                    # streaming multiprocessors of an H100 SXM

#: number of times the kernel has been launched (incremented only where
#: it is launched)
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def plan(B, T, H) -> tuple[int, int]:
    """(groups, splits) for a call on (B, T, H, dh) inputs.

    A prefill splits each state column over the most threads G (up to
    8) with B H G <= 2,048: the token loop is sequential, and more
    threads shorten each token until the batch's float32 work fills the
    card (at dh = 64, 131,072 threads); past that they only add reads. A
    decode step (T = 1) reads and writes the state once, and takes G = 4.
    The columns of a pair go to 2 blocks while the B H pairs are fewer
    than the SMs. (The layouts timed on an H100 that chose these are in
    PERF.md.)"""
    pairs = B * H
    splits = 2 if pairs < SMS else 1
    if T <= 1:
        return 4, splits
    groups = max((g for g in GROUPS if pairs * g <= 2048), default=1)
    return groups, splits


def wkv(r, k, v, w, u, state):
    """r,k,v,w: (B,T,H,dh); u: (H,dh); state: (B,H,dh,dh) float32.
    Returns (y (B,T,H,dh) in r's dtype, final state float32)."""
    _check(r, k, v, w, u, state)
    B, T, H, _ = r.shape
    return _launch(r, k, v, w, u, state, *plan(B, T, H))


def _wkv_planned(r, k, v, w, u, state, groups, splits):
    """``wkv`` with (groups, splits) given, not planned: for timing one
    layout against another on the same inputs."""
    _check(r, k, v, w, u, state)
    if groups not in GROUPS or splits not in SPLITS:
        raise ValueError(f"wkv: groups must be in {GROUPS} and splits in "
                         f"{SPLITS}, got {groups}, {splits}")
    return _launch(r, k, v, w, u, state, groups, splits)


def _check(r, k, v, w, u, state):
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
    if any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("wkv: r, k, v and w must be 16-byte aligned (the "
                         "kernel copies 16 bytes at a time)")


def _launch(r, k, v, w, u, state, groups, splits):
    global LAUNCHES
    B, T, H, dh = r.shape
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    fn = _build.function("rwkv6_wkv", "rwkv6_wkv_fwd", _ARGTYPES)
    _build.launch("rwkv6_wkv", fn, r.device, r.data_ptr(), k.data_ptr(),
                  v.data_ptr(), w.data_ptr(), u.data_ptr(),
                  state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                  DTYPES[r.dtype], B, T, H, dh, groups, splits)
    LAUNCHES += 1
    return y, s_out
