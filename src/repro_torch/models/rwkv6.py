"""RWKV-6 "Finch" time-mix and channel-mix (counterpart of
``repro/models/rwkv6.py``).

Token shift with the data-dependent lerp (the 5-way LoRA), per-channel
data-dependent decay w = exp(-exp(.)), bonus u, a (dh x dh) wkv state
per head, per-head group norm, squared-ReLU channel mix; norms are
RMSNorm, as in the reference.

``wkv_scan`` is the sequential recurrence, one token at a time with a
float32 state. It is the plain version the CUDA wkv kernel is held
against (``kernels/ref.py``); ``time_mix`` takes the kernel through
``kernel_fn``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_dense

LORA_DIM = 32
DECAY_LORA_DIM = 64


def rwkv_init(gen, cfg, dtype):
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    H = d // dh
    dev = gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    return {
        # time-mix (attention analogue)
        "maa_x": full((d,), 0.0),
        "maa_wkvrg": full((5, d), 0.0),
        "tm_w1": init_dense(gen, d, 5 * LORA_DIM, dtype),
        "tm_w2": normal((5, LORA_DIM, d), LORA_DIM ** -0.5),
        "w0": full((d,), -1.0),                 # base decay logit
        "td_w1": init_dense(gen, d, DECAY_LORA_DIM, dtype),
        "td_w2": init_dense(gen, DECAY_LORA_DIM, d, dtype),
        "u": normal((H, dh), 0.1),
        "wr": init_dense(gen, d, d, dtype),
        "wk": init_dense(gen, d, d, dtype),
        "wv": init_dense(gen, d, d, dtype),
        "wg": init_dense(gen, d, d, dtype),
        "wo": init_dense(gen, d, d, dtype),
        "gn_w": full((d,), 1.0),
        # channel mix
        "cm_maa_k": full((d,), 0.0),
        "cm_maa_r": full((d,), 0.0),
        "cm_wk": init_dense(gen, d, cfg.d_ff, dtype),
        "cm_wv": init_dense(gen, cfg.d_ff, d, dtype),
        "cm_wr": init_dense(gen, d, d, dtype),
    }


def _group_norm(x, weight, H, eps=1e-5):
    """Per-head normalisation. x: (..., H*dh); float32 inside."""
    shp = x.shape
    xh = x.reshape(*shp[:-1], H, shp[-1] // H).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, unbiased=False)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(shp) * weight.float()).to(x.dtype)


def _ddlerp(p, x, sx):
    """Data-dependent token-shift lerp -> (xw, xk, xv, xr, xg)."""
    xxx = x + sx * p["maa_x"]
    lora = torch.tanh(xxx @ p["tm_w1"])
    lora = lora.reshape(*lora.shape[:-1], 5, LORA_DIM)
    deltas = torch.einsum("...fk,fkd->...fd", lora, p["tm_w2"])
    mix = p["maa_wkvrg"] + deltas          # (..., 5, d)
    return tuple(x + sx * mix[..., i, :] for i in range(5))


def wkv_scan(r, k, v, w, u, state):
    """Sequential wkv recurrence.

    r,k,v,w: (B,T,H,dh); u: (H,dh); state: (B,H,dh,dh) [k-dim x v-dim].
    Returns (y (B,T,H,dh) in r's dtype, final state float32). Per token:
    y_j = sum_i r_i (S_ij + u_i k_i v_j), then S_ij <- w_i S_ij + k_i v_j.
    """
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # (B,H,dh,dh)
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t],
                               s + uf[..., None] * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def _shifted(x, shift_state):
    """The previous token of each position: shift_state for t = 0."""
    return torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)


def time_mix(p, cfg, x, shift_state, wkv_state, kernel_fn=None):
    """x: (B,T,d). shift_state: (B,d) (last token of the previous
    segment). Returns (out, new_shift_state, new_wkv_state)."""
    B, T, d = x.shape
    dh = cfg.rwkv_head_dim
    H = d // dh
    sx = _shifted(x, shift_state) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)

    r = (xr @ p["wr"]).reshape(B, T, H, dh)
    k = (xk @ p["wk"]).reshape(B, T, H, dh)
    v = (xv @ p["wv"]).reshape(B, T, H, dh)
    g = F.silu(xg @ p["wg"])
    w = torch.exp(-torch.exp((p["w0"] + torch.tanh(xw @ p["td_w1"])
                              @ p["td_w2"]).float())).reshape(B, T, H, dh)

    wkv = kernel_fn or wkv_scan
    # the decays reach the recurrence in r's dtype, as in the reference
    y, wkv_state = wkv(r, k, v, w.to(r.dtype), p["u"], wkv_state)
    y = _group_norm(y.reshape(B, T, d), p["gn_w"], H)
    out = (y * g) @ p["wo"]
    return out, x[:, -1, :], wkv_state


def channel_mix(p, x, shift_state):
    sx = _shifted(x, shift_state) - x
    xk = x + sx * p["cm_maa_k"]
    xr = x + sx * p["cm_maa_r"]
    k = torch.square(torch.relu(xk @ p["cm_wk"]))
    return torch.sigmoid(xr @ p["cm_wr"]) * (k @ p["cm_wv"]), x[:, -1, :]


def rwkv_state_init(cfg, batch, dtype=None, device="cuda"):
    """Per-layer recurrent state. Token-shift states are in the model
    dtype (they join the activations); the wkv state stays float32."""
    d, dh = cfg.d_model, cfg.rwkv_head_dim
    H = d // dh
    dtype = dtype or cfg.dtype
    return {
        "att_shift": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                           device=device),
        "cm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
    }
