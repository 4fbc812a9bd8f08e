"""Mamba (S6) selective state-space block for the Jamba hybrid
(counterpart of ``repro/models/mamba.py``).

The S6 recurrence: input-dependent (dt, B, C), A = -exp(A_log), ZOH
discretisation dA = exp(dt A), dB = dt B. The reference's time scan is
one ``lax.scan`` carrying h (B, d_inner, d_state) in float32, outside
any Pallas kernel; here it is a Python loop over T of the same float32
operations, slicing each step's inputs so that the (B, T, d_inner,
d_state) discretised tensor is never materialised. The depthwise
causal convolution sums its d_conv taps in the reference's order and
dtype (Python's ``sum``, from 0, in ``x.dtype``).

Tensor parallelism over a mesh's 'model' axis (``models.model``): a
rank holds a block of the channels -- the x and z columns of
``in_proj`` for them (``collectives.Halves``), their blocks of
``conv_w``/``conv_b``/``dt_proj``/``dt_bias``/``A_log``/``D``, their
rows of ``x_proj`` and ``out_proj``, their ``conv`` and ``h`` states --
and ``mamba_forward(..., reduce=)`` sums the ranks' partial
(dt_rank + 2 d_state) projections; the output is the rank's partial
sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_dense


def mamba_dims(cfg):
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, mc.d_state, mc.d_conv


def mamba_init(gen, cfg, dtype):
    d = cfg.d_model
    d_in, dt_rank, d_state, d_conv = mamba_dims(cfg)
    dev = gen.device
    A = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=dev).expand(d_in, d_state)
    return {
        "in_proj": init_dense(gen, d, 2 * d_in, dtype),
        "conv_w": (torch.randn((d_conv, d_in), generator=gen, device=dev)
                   * d_conv ** -0.5).to(dtype),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=dev),
        "x_proj": init_dense(gen, d_in, dt_rank + 2 * d_state, dtype),
        "dt_proj": init_dense(gen, dt_rank, d_in, dtype),
        "dt_bias": torch.zeros((d_in,), dtype=dtype, device=dev),
        "A_log": torch.log(A),
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": init_dense(gen, d_in, d, dtype),
    }


def _conv_taps(ctx, w, T):
    """sum_i ctx[:, i:i+T] * w[i] over the d_conv taps, in order, from
    0 (Python's ``sum``, as the reference writes it)."""
    return sum(ctx[:, i:i + T, :] * w[i] for i in range(w.shape[0]))


def _causal_conv(x, w, b):
    """x: (B,T,d_in); w: (d_conv, d_in) depthwise causal conv."""
    pad = F.pad(x, (0, 0, w.shape[0] - 1, 0))
    return _conv_taps(pad, w, x.shape[1]) + b


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) for every x (torch's
    ``softplus`` returns x itself above a threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssm_scan(u, dt, Bs, Cs, A, D, h0):
    """Selective scan. u, dt: (B,T,d_in); Bs, Cs: (B,T,d_state);
    A: (d_in, d_state); h0: (B, d_in, d_state). Returns (y in u's
    dtype, hT float32)."""
    uf, dtf, Bf, Cf = (t.float() for t in (u, dt, Bs, Cs))
    h = h0.float()
    ys = []
    for t in range(u.shape[1]):
        ut, dtt, bt, ct = uf[:, t], dtf[:, t], Bf[:, t], Cf[:, t]
        dA = torch.exp(dtt[..., None] * A)                   # (B,d_in,N)
        dBu = (dtt * ut)[..., None] * bt[:, None, :]         # (B,d_in,N)
        h = dA * h + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, ct) + D * ut)
    return torch.stack(ys, dim=1).to(u.dtype), h


def mamba_forward(p, cfg, x, state=None, reduce=None):
    """x: (B,T,d). state: None (fresh) or dict(conv (B,d_conv-1,d_in),
    h (B,d_in,d_state)) for segment continuation. Returns (out, new
    state), the state float32.

    ``reduce`` (tensor parallelism): ``p`` and the state hold a rank's
    block of the channels (d_in = ``conv_w``'s width), ``reduce`` sums
    the ranks' partial x_proj products, and ``out`` is the rank's
    partial sum."""
    B, T, _ = x.shape
    _, dt_rank, d_state, d_conv = mamba_dims(cfg)
    d_in = p["conv_w"].shape[1]
    xz = x @ p["in_proj"]
    xs, z = xz.chunk(2, dim=-1)

    if state is not None:
        ctx = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
        conv_in = ctx[:, -(T + d_conv - 1):, :]
        xs_c = F.silu(_conv_taps(conv_in, p["conv_w"], T) + p["conv_b"])
        new_conv = ctx[:, -(d_conv - 1):, :]
        h0 = state["h"]
    else:
        xs_c = F.silu(_causal_conv(xs, p["conv_w"], p["conv_b"]))
        new_conv = torch.cat(
            [torch.zeros((B, d_conv - 1, d_in), dtype=xs.dtype,
                         device=x.device), xs], dim=1)[:, -(d_conv - 1):, :]
        h0 = torch.zeros((B, d_in, d_state), dtype=torch.float32,
                         device=x.device)

    proj = xs_c @ p["x_proj"]
    if reduce is not None:
        proj = reduce(proj)
    dt = _softplus(proj[..., :dt_rank] @ p["dt_proj"] + p["dt_bias"])
    Bs = proj[..., dt_rank:dt_rank + d_state]
    Cs = proj[..., dt_rank + d_state:]
    A = -torch.exp(p["A_log"])

    y, hT = ssm_scan(xs_c, dt, Bs, Cs, A, p["D"], h0)
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, {"conv": new_conv.float(), "h": hT}


def mamba_state_init(cfg, batch, device=None):
    d_in, _, d_state, d_conv = mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_in), dtype=torch.float32,
                            device=device),
        "h": torch.zeros((batch, d_in, d_state), dtype=torch.float32,
                         device=device),
    }
