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

Training: ``wkv_ckpt`` is the same launch, also writing the state before
every chunk of ``CHUNK`` tokens into a float32 scratch (B, H,
ceil(T / CHUNK), dh, dh) that the caller keeps for the backward (at
(2, 4096, 64, 64), 537 MB); ``wkv_bwd`` recomputes each chunk's states
from it (never dividing by the decay, which reaches 0) and returns dr,
dk, dv, dw, du and the initial state's gradient from the hand-written
backward kernel (dh = 64 only, ``BWD_HEAD_DIMS``; no atomics, the same
bits every run): one block of 256 threads a (head, sequence) pair, a
thread two rows of the state at 8 columns, the recomputed states in
registers.
``BWD_LAUNCHES`` counts its launches. The reference has no backward
kernel: its Pallas kernel cannot be differentiated.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_HEAD_DIMS = (64,)
CHUNK = 16                   # tokens between the forward's saved states
GROUPS = (1, 2, 4, 8)        # threads per state column
SPLITS = (1, 2, 4)           # blocks per (head, sequence)
SMS = 132                    # streaming multiprocessors of an H100 SXM

#: number of times the kernel has been launched (incremented only where
#: it is launched)
LAUNCHES = 0
#: launches of the backward kernel
BWD_LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])


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


def wkv_ckpt(r, k, v, w, u, state):
    """``wkv`` that also returns the states before every chunk of
    ``CHUNK`` tokens, float32 (B, H, ceil(T / CHUNK), dh, dh): the
    forward of a training step, for ``wkv_bwd``."""
    _check(r, k, v, w, u, state)
    ckpt = torch.empty(ckpt_shape(r), dtype=torch.float32, device=r.device)
    y, s_out = _launch(r, k, v, w, u, state, *plan(*r.shape[:3]), ckpt)
    return y, s_out, ckpt


def ckpt_shape(r) -> tuple:
    """(B, H, ceil(T / CHUNK), dh, dh): ``wkv_ckpt``'s states of r (B, T,
    H, dh)."""
    B, T, H, dh = r.shape
    return (B, H, -(-T // CHUNK), dh, dh)


def wkv_bwd(r, k, v, w, u, ckpt, dy, ds_out=None):
    """Gradients (dr, dk, dv, dw like r; du (H, dh) like u; ds0 float32
    (B, H, dh, dh)) of ``wkv``'s (y, final state) given ``ckpt`` from
    ``wkv_ckpt``, ``dy`` (like y) and ``ds_out``, the final state's
    gradient (None: unused)."""
    global BWD_LAUNCHES
    B, T, H, dh = r.shape
    dev = r.device
    _check(r, k, v, w, u)
    if dh not in BWD_HEAD_DIMS:
        raise ValueError(f"wkv_bwd: the backward kernel takes head dims "
                         f"{BWD_HEAD_DIMS}, got {dh}")
    _build.check("wkv_bwd", "ckpt", ckpt, torch.float32,
                 (B, H, -(-T // CHUNK), dh, dh), dev)
    _build.check("wkv_bwd", "dy", dy, r.dtype, (B, T, H, dh), dev)
    if ds_out is not None:
        _build.check("wkv_bwd", "ds_out", ds_out, torch.float32,
                     (B, H, dh, dh), dev)
    if any(t.data_ptr() % 16 for t in (ckpt, dy, ds_out) if t is not None):
        raise ValueError("wkv_bwd: ckpt, dy and ds_out must be 16-byte "
                         "aligned (the kernel reads 16 bytes at a time)")
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((B, H, dh), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, dh, dh), dtype=torch.float32, device=dev)
    fn = _build.function("rwkv6_wkv", "rwkv6_wkv_bwd", _BWD_ARGTYPES)
    _build.launch("rwkv6_wkv_bwd", fn, dev, r.data_ptr(), k.data_ptr(),
                  v.data_ptr(), w.data_ptr(), u.data_ptr(), ckpt.data_ptr(),
                  dy.data_ptr(),
                  None if ds_out is None else ds_out.data_ptr(),
                  dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                  du.data_ptr(), ds0.data_ptr(), DTYPES[r.dtype], B, T, H, dh)
    BWD_LAUNCHES += 1
    return dr, dk, dv, dw, du.sum(0).to(u.dtype), ds0


def _wkv_planned(r, k, v, w, u, state, groups, splits):
    """``wkv`` with (groups, splits) given, not planned: for timing one
    layout against another on the same inputs."""
    _check(r, k, v, w, u, state)
    if groups not in GROUPS or splits not in SPLITS:
        raise ValueError(f"wkv: groups must be in {GROUPS} and splits in "
                         f"{SPLITS}, got {groups}, {splits}")
    return _launch(r, k, v, w, u, state, groups, splits)


def _check(r, k, v, w, u, state=None):
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
    if state is not None:
        _build.check("wkv", "state", state, torch.float32, (B, H, dh, dh),
                     dev)
    if any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("wkv: r, k, v and w must be 16-byte aligned (the "
                         "kernel copies 16 bytes at a time)")


def _launch(r, k, v, w, u, state, groups, splits, ckpt=None):
    global LAUNCHES
    B, T, H, dh = r.shape
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    fn = _build.function("rwkv6_wkv", "rwkv6_wkv_fwd", _ARGTYPES)
    _build.launch("rwkv6_wkv", fn, r.device, r.data_ptr(), k.data_ptr(),
                  v.data_ptr(), w.data_ptr(), u.data_ptr(),
                  state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                  None if ckpt is None else ckpt.data_ptr(),
                  DTYPES[r.dtype], B, T, H, dh, groups, splits)
    LAUNCHES += 1
    return y, s_out
