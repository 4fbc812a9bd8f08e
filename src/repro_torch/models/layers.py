"""Common model primitives (counterpart of ``repro/models/layers.py``):
norms, RoPE, the SwiGLU/GELU MLP, initialisers, the output head and
the training loss (``cross_entropy``).

Norms and RoPE compute in float32 and cast back to the input's dtype at
the same places as the reference. Initialisers draw float32 normals
from an explicit ``torch.Generator`` on the target device and cast.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init_dense(gen, d_in, d_out, dtype, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device)
            * scale).to(dtype)


def rms_norm(x, gamma, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


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
    output (``torch.mm(..., out_dtype=torch.float32)``); on the CPU the
    operands are cast (the CPU runs the float32 reduced configs).
    """
    B, T, d = x.shape
    if x.dtype == w.dtype and x.dtype in (torch.float32, torch.float64):
        return x @ w.t()
    if x.is_cuda:
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


def cross_entropy(logits, targets, mask=None):
    """Mean negative log-likelihood over (optionally masked) positions;
    logits float32 (B, T, V), targets (B, T) int.

    The reference takes the gold logit with an iota-compare reduction
    (its reason is GSPMD sharding of the vocab); a gather picks the same
    value (the other terms of that sum are zeros) without a (B, T, V)
    mask, which at full width is as large as the logits."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
