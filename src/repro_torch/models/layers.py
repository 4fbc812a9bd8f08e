"""Common model primitives (counterpart of ``repro/models/layers.py``):
norms, RoPE, the SwiGLU/GELU MLP, initialisers, the output head and
the training loss (``cross_entropy``; on a mesh whose 'model' axis
holds the vocab in blocks, ``vocab_parallel_nll``).

Norms and RoPE compute in float32 and cast back to the input's dtype at
the same places as the reference. Initialisers draw float32 normals
from an explicit ``torch.Generator`` on the target device and cast.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C


def init_dense(gen, d_in, d_out, dtype, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device)
            * scale).to(dtype)


def rms_norm(x, gamma, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


class _GatheredRmsNorm(torch.autograd.Function):
    """``rms_norm`` of a residual gathered whole over a mesh axis from
    the rank's block (dimension ``dim``: 1 the sequence, 2 d), for a
    consumer each rank uses for its share of the output (a
    tensor-parallel part): the gradient reaching the norm is then a
    partial sum on each rank. The backward reduce-scatters it into the
    block first -- the sum one device's norm backward starts from -- and
    runs autograd's rms_norm backward on the block: a row's sum over d
    summed over the axis when d is cut, the gain's gradient gathered
    from the ranks' column blocks (or summed over their row blocks)."""

    @staticmethod
    def forward(ctx, x, gamma, eps, dist, axis, dim):
        xf = C.all_gather_(dist, axis, x, dim).float()
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        ctx.args = (dist, axis, dim, xf.shape[-1])
        ctx.save_for_backward(x, gamma, r if dim == 2 else
                              C.block_of(dist, axis, r, dim).contiguous())
        return (xf * r * gamma.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, gamma, r = ctx.saved_tensors
        dist, axis, dim, d = ctx.args
        g = C.reduce_scatter_(dist, axis, g.contiguous(), dim).float()
        xf, gf = x.float(), gamma.float()
        if dim == 2:
            gf = C.block_of(dist, axis, gf, 0)
        dxn = g * gf
        dgamma = (g * (xf * r)).sum(dim=(0, 1))
        dr = (dxn * xf).sum(dim=-1, keepdim=True)
        if dim == 2:
            dr = C.all_reduce_(dist, axis, dr)
            dgamma = C.all_gather_(dist, axis, dgamma, 0)
        else:
            dgamma = C.all_reduce_(dist, axis, dgamma)
        dsq = -0.5 * dr * r.pow(3) / d
        dx = dxn * r + (dsq * xf + dsq * xf)
        return dx.to(x.dtype), dgamma.to(gamma.dtype), None, None, None, \
            None


def gathered_rms_norm(x, gamma, eps, dist, axis, dim):
    """``rms_norm`` of the whole residual from the rank's block ``x``
    (dimension ``dim`` cut over ``axis``), for a tensor-parallel
    consumer (``_GatheredRmsNorm``): an all-gather forward, a
    reduce-scatter backward."""
    return _GatheredRmsNorm.apply(x, gamma, eps, dist, axis, dim)


def rope_freqs(d_rot: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                         device=device) / d_rot))


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, d) with d even; positions: (..., T) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (d/2,)
    ang = positions[..., None].float() * freqs               # (..., T, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu_init(gen, d_model, d_ff, dtype, variant="swiglu"):
    p = {}
    if variant == "swiglu":
        p["w_gate"] = init_dense(gen, d_model, d_ff, dtype)
    p["w_up"] = init_dense(gen, d_model, d_ff, dtype)
    p["w_down"] = init_dense(gen, d_ff, d_model, dtype)
    return p


def swiglu_apply(p, x):
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:                      # 2-matrix GELU MLP (GPTBigCode / granite)
        h = F.gelu(x @ p["w_up"], approximate="tanh")   # jax.nn.gelu
    return h @ p["w_down"]


def embed_init(gen, vocab, d_model, dtype):
    return (torch.randn((vocab, d_model), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def unembed(x, w):
    """x: (B, T, d), w: (vocab, d) -> float32 logits (B, T, vocab).

    As the reference's ``preferred_element_type=float32``: products of
    the operands' own values summed in float32, with no float32 copy of
    the head. On the card a bf16/fp16 head goes to cuBLAS with a float32
    output (``torch.mm(..., out_dtype=torch.float32)``), and so do
    ``meta`` tensors (the dry run's count of the card's step); on the
    CPU the operands are cast (the CPU runs the float32 reduced configs).
    """
    B, T, d = x.shape
    if x.dtype == w.dtype and x.dtype in (torch.float32, torch.float64):
        return x @ w.t()
    if x.is_cuda or x.is_meta:
        x2 = x.reshape(B * T, d)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _Unembed.apply(x2, w).reshape(B, T, -1)
        return torch.mm(x2, w.t(), out_dtype=torch.float32).reshape(B, T, -1)
    return x.float() @ w.float().t()


class _Unembed(torch.autograd.Function):
    """x (N, d) @ w.t() with a float32 output from bf16/fp16 operands
    (cuBLAS, float32 sums); the backward takes the float32 gradient of
    the logits in the operands' dtype (the mixed-precision step's
    rounding) into two GEMMs with float32 sums, each gradient in its
    operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w, g.t() @ x


class _Nll(torch.autograd.Function):
    """logsumexp(logits) - logits[target] a position; the backward
    writes the logits' gradient into one buffer (g exp(logits - lse),
    then -g added at the targets): the ops and roundings of autograd's
    logsumexp and gather backwards and their sum, without their three
    logits-sized temporaries (a rank's float32 logits at full width are
    2.5 GB)."""

    @staticmethod
    def forward(ctx, logits, targets):
        lse = torch.logsumexp(logits, dim=-1)
        idx = targets[..., None].long()
        ctx.save_for_backward(logits, idx, lse)
        return lse - torch.gather(logits, -1, idx)[..., 0]

    @staticmethod
    def backward(ctx, g):
        logits, idx, lse = ctx.saved_tensors
        d = logits - lse[..., None]
        d.exp_()
        d.mul_(g[..., None])
        d.scatter_add_(-1, idx, -g[..., None])
        return d, None


class _VocabParallelNll(torch.autograd.Function):
    """``_Nll`` on logits whose vocab is cut into blocks over a mesh
    axis, a rank holding its block (..., V / m): the log-sum-exp from
    the ranks' maxima (a ``pmax``) and their sums of exp(logits - max)
    (a ``psum``), the gold logit from the rank's masked local pick
    summed in the same ``psum`` (the reference's iota-compare over a
    vocab block). The backward writes the rank's block only, in one
    buffer: g (softmax - onehot) over the block."""

    @staticmethod
    def forward(ctx, logits, targets, dist, axis):
        V = logits.shape[-1]
        idx = targets[..., None].long() - C.axis_index(dist, axis) * V
        inside = (idx >= 0) & (idx < V)
        idx = idx.clamp(0, V - 1)
        m = C.pmax(logits.amax(dim=-1), dist, axis)
        gold = torch.gather(logits, -1, idx)
        gold = torch.where(inside, gold, torch.zeros_like(gold))[..., 0]
        s = torch.exp(logits - m[..., None]).sum(dim=-1)
        s, gold = C.all_reduce_(dist, axis, torch.stack([s, gold]))
        lse = torch.log(s) + m
        ctx.save_for_backward(logits, idx, inside, lse)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, idx, inside, lse = ctx.saved_tensors
        d = logits - lse[..., None]
        d.exp_()
        d.mul_(g[..., None])
        gi = g[..., None]
        d.scatter_add_(-1, idx, torch.where(inside, -gi,
                                            torch.zeros_like(gi)))
        return d, None, None, None


def vocab_parallel_nll(logits, targets, dist, axis):
    """The negative log-likelihood of each position from the rank's
    vocab block of the float32 logits (..., V / m) over ``axis`` (block
    r holds vocab [r V / m, (r + 1) V / m)); targets (...) int, global
    ids. Every rank of ``axis`` gets the same values."""
    return _VocabParallelNll.apply(logits, targets, dist, axis)


def nll(logits, targets):
    """The negative log-likelihood of each position: float32 logits (...,
    V), targets (...) int."""
    return _Nll.apply(logits, targets)


def masked_mean(values, mask=None):
    """The mean of ``values`` over the positions of ``mask`` (all when
    None): a sum over the clamped count of the mask."""
    if mask is not None:
        mask = mask.float()
        return torch.sum(values * mask) / torch.clamp(torch.sum(mask),
                                                      min=1.0)
    return torch.mean(values)


def cross_entropy(logits, targets, mask=None):
    """Mean negative log-likelihood over (optionally masked) positions;
    logits float32 (B, T, V), targets (B, T) int.

    The reference takes the gold logit with an iota-compare reduction
    (its reason is GSPMD sharding of the vocab); a gather picks the same
    value (the other terms of that sum are zeros) without a (B, T, V)
    mask, which at full width is as large as the logits."""
    return masked_mean(nll(logits, targets), mask)
