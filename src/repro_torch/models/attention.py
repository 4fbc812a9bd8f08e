"""Attention, GQA half (counterpart of ``repro/models/attention.py``):
GQA with qk-norm, sliding window or bidirectional masks.

Full-sequence attention never materialises a (T, S) score matrix
beyond one (chunk_q, chunk_k) block per head: ``chunked_attention``
scans KV chunks with an online softmax. It is also the plain version
the CUDA flash-attention kernel is held against (``kernels/ref.py``).

Decode: a (B, 1) query against a (B, S, n_kv, dh) cache (a rolling
window for SWA archs). Unlike the reference's functional update, the
decode step writes the new row into the cache tensors in place and
returns them.

MLA (``mla_init``/``mla_forward``/``mla_decode``) and the
sequence-parallel ``gqa_decode_sp`` are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, init_dense, rms_norm

NEG_INF = -1e30


def gqa_init(gen, cfg, dtype):
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    p = {
        "wq": init_dense(gen, d, H * dh, dtype),
        "wk": init_dense(gen, d, Hkv * dh, dtype),
        "wv": init_dense(gen, d, Hkv * dh, dtype),
        "wo": init_dense(gen, H * dh, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((dh,), dtype=dtype, device=gen.device)
    return p


def chunked_attention(q, k, v, *, causal=True, swa_window=0,
                      chunk_q=1024, chunk_k=1024):
    """q: (B,T,H,dq), k: (B,S,H,dq), v: (B,S,H,dv) -> (B,T,H,dv) in v's
    dtype.

    Scores, running max, denominator and accumulator are float32.
    Masked scores are NEG_INF (-1e30), as in the reference, so a row
    with no visible key averages the values. T must be a multiple of
    min(chunk_q, T) and S of min(chunk_k, S). Assumes T == S when causal.
    """
    B, T, H, dq = q.shape
    S, dv = k.shape[1], v.shape[-1]
    scale = dq ** -0.5
    cq, ck = min(chunk_q, T), min(chunk_k, S)
    if T % cq or S % ck:
        raise ValueError(f"chunked_attention: T={T}, S={S} are not "
                         f"multiples of the chunks ({cq}, {ck})")
    dev = q.device
    outs = []
    for q0 in range(0, T, cq):
        qb = q[:, q0:q0 + cq].float() * scale              # (B,cq,H,dq)
        qp = torch.arange(q0, q0 + cq, device=dev)
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, cq, dv), dtype=torch.float32, device=dev)
        for k0 in range(0, S, ck):
            kb = k[:, k0:k0 + ck].float()
            vb = v[:, k0:k0 + ck].float()
            kp = torch.arange(k0, k0 + ck, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb)
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= qp[:, None] >= kp[None, :]
            if swa_window:
                mask &= qp[:, None] - kp[None, :] < swa_window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vb)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,H,cq,dv)
        outs.append(out.transpose(1, 2))                   # (B,cq,H,dv)
    return torch.cat(outs, dim=1).to(v.dtype)


def _repeat_kv(x, n_rep):
    if n_rep == 1:
        return x
    B, S, Hkv, dh = x.shape
    return x[:, :, :, None, :].expand(B, S, Hkv, n_rep, dh) \
        .reshape(B, S, Hkv * n_rep, dh)


def _project_qkv(p, cfg, x, positions):
    B, T, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    q = (x @ p["wq"]).reshape(B, T, H, dh)
    k = (x @ p["wk"]).reshape(B, T, Hkv, dh)
    v = (x @ p["wv"]).reshape(B, T, Hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p, cfg, x, *, positions, kernel_fn=None):
    """Full-sequence attention. x: (B,T,d). Returns (out, (k, v)) with
    k, v the un-repeated (B,T,n_kv,dh) cache rows."""
    B, T, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    q, k, v = _project_qkv(p, cfg, x, positions)
    kf, vf = _repeat_kv(k, H // Hkv), _repeat_kv(v, H // Hkv)
    if kernel_fn is not None:
        out = kernel_fn(q, kf, vf, causal=cfg.causal,
                        swa_window=cfg.swa_window)
    else:
        out = chunked_attention(q, kf, vf, causal=cfg.causal,
                                swa_window=cfg.swa_window,
                                chunk_q=cfg.attn_chunk,
                                chunk_k=cfg.attn_chunk)
    return out.reshape(B, T, H * dh) @ p["wo"], (k, v)


def gqa_decode(p, cfg, x, cache, pos):
    """One-token decode. x: (B,1,d); cache: dict(k,v: (B,S,Hkv,dh));
    pos: (B,) int. Writes the new row at ``pos`` (``pos % S`` for SWA
    archs) into the cache tensors in place; a row whose index is past
    the cache is not written, as the reference's scatter drops it."""
    B = x.shape[0]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    kc, vc = cache["k"], cache["v"]
    S = kc.shape[1]
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])

    write_idx = pos % S if cfg.swa_window else pos
    inside = (write_idx < S)[:, None, None]
    idx = write_idx.clamp(max=S - 1)
    rows = torch.arange(B, device=x.device)
    kc[rows, idx] = torch.where(inside, k[:, 0].to(kc.dtype), kc[rows, idx])
    vc[rows, idx] = torch.where(inside, v[:, 0].to(vc.dtype), vc[rows, idx])

    kf, vf = _repeat_kv(kc, H // Hkv), _repeat_kv(vc, H // Hkv)
    s = torch.einsum("bqhd,bshd->bhqs", q.float() * dh ** -0.5, kf.float())
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    if cfg.swa_window:
        # rolling cache: once pos >= S-1 every slot holds a live entry
        valid = valid | (pos[:, None] >= S - 1)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", prob, vf.float())
    out = out.to(x.dtype).reshape(B, 1, H * dh)
    return out @ p["wo"], {"k": kc, "v": vc}
