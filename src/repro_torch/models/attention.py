"""Attention (counterpart of ``repro/models/attention.py``): GQA with
qk-norm, sliding window or bidirectional masks, and MLA.

Full-sequence attention never materialises a (T, S) score matrix
beyond one (chunk_q, chunk_k) block per head: ``chunked_attention``
scans KV chunks with an online softmax. It is also the plain version
the CUDA flash-attention kernel is held against (``kernels/ref.py``).

Decode paths:
  * GQA: a (B, 1) query against a (B, S, n_kv, dh) cache (a rolling
    window for SWA archs);
  * MLA: absorbed-weight latent attention against a (B, S, kv_lora) +
    (B, S, rope) cache, float32 einsums as in the reference (which
    computes it outside any Pallas kernel).
Unlike the reference's functional update, both decode steps write the
new row into the cache tensors in place and return them.

MLA's prefill hands the attention kernel q/k of nope + rope dims and v
of ``v_head_dim`` (minicpm3: 96 and 64); the kernel takes dv != dq.

On a mesh (``models.moe.DistContext``) ``gqa_decode_sp`` decodes one
token against a KV cache whose sequence is cut into blocks over mesh
axes (the reference's flash-decoding ``shard_map``, over whichever axes
the cache's layout names, a sliding window's rolling cache among them),
and ``mla_decode(..., dist, axes)`` does the same over MLA's latent
rows; the tensor-parallel forward and decode (``models.model``) run
``gqa_forward`` / ``gqa_decode`` on a rank's heads.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C
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


def mla_init(gen, cfg, dtype):
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    return {
        "wdq": init_dense(gen, d, m.q_lora_rank, dtype),
        "wuq": init_dense(gen, m.q_lora_rank, H * qk_head, dtype),
        "wdkv": init_dense(gen, d, m.kv_lora_rank, dtype),
        "wkr": init_dense(gen, d, m.qk_rope_head_dim, dtype),
        "wuk": init_dense(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                          dtype),
        "wuv": init_dense(gen, m.kv_lora_rank, H * m.v_head_dim, dtype),
        "wo": init_dense(gen, H * m.v_head_dim, d, dtype),
        "q_ln": torch.ones((m.q_lora_rank,), dtype=dtype, device=dev),
        "kv_ln": torch.ones((m.kv_lora_rank,), dtype=dtype, device=dev),
    }


def attn_init(gen, cfg, dtype):
    return mla_init(gen, cfg, dtype) if cfg.attn_type == "mla" \
        else gqa_init(gen, cfg, dtype)


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


def _write_row(cache, idx, row):
    """``cache[b, idx[b]] = row[b]`` for every batch row b, in place; a
    row whose index is past the cache is not written, as the
    reference's scatter drops it."""
    S = cache.shape[1]
    inside = (idx < S).view(-1, *[1] * (row.dim() - 1))
    at = idx.clamp(max=S - 1)
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, at] = torch.where(inside, row.to(cache.dtype),
                                  cache[rows, at])


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
    _write_row(kc, write_idx, k[:, 0])
    _write_row(vc, write_idx, v[:, 0])

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


def mla_forward(p, cfg, x, *, positions, kernel_fn=None):
    """Full-sequence MLA (naive, un-absorbed). x: (B,T,d). Returns (out,
    (c_kv (B,T,kv_lora), k_rope (B,T,rope))), the latent cache rows."""
    m = cfg.mla
    B, T, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    cq = rms_norm(x @ p["wdq"], p["q_ln"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(B, T, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = rms_norm(x @ p["wdkv"], p["kv_ln"], cfg.norm_eps)   # (B,T,r)
    k_rope = apply_rope((x @ p["wkr"])[:, :, None, :], positions,
                        cfg.rope_theta)                        # (B,T,1,dr)
    k_nope = (c_kv @ p["wuk"]).reshape(B, T, H, dn)
    v = (c_kv @ p["wuv"]).reshape(B, T, H, dv)

    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(B, T, H, dr)], dim=-1)
    if kernel_fn is not None:
        out = kernel_fn(qf, kf, v, causal=cfg.causal)
    else:
        out = chunked_attention(qf, kf, v, causal=cfg.causal,
                                chunk_q=cfg.attn_chunk,
                                chunk_k=cfg.attn_chunk)
    out = out.reshape(B, T, H * dv) @ p["wo"]
    return out, (c_kv, k_rope[:, :, 0, :])


def mla_decode(p, cfg, x, cache, pos, dist=None, axes=None):
    """Absorbed-weight MLA decode. x: (B,1,d); cache: dict(c_kv
    (B,S,kv_lora), k_rope (B,S,rope)); pos: (B,) int. Writes the new
    latent row at ``pos`` into the cache tensors in place (a row past
    the cache is not written).

    On a mesh (``dist``, ``axes``) the cache's sequence is cut into
    blocks over ``axes``: the rank whose block holds ``pos`` writes the
    new row, every rank scores its rows with the absorbed query, and
    the partial softmax over the latent rows is combined as
    ``gqa_decode_sp``'s (a ``pmax`` and two ``psum``s of (B, H) and (B,
    H, kv_lora) values). The weights are whole, as in the reference."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                     m.v_head_dim, m.kv_lora_rank)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    S = c_kv.shape[1]
    s0, at = 0, pos
    if axes:
        s0, _, at = _seq_block(dist, axes, S, pos, False)

    cq = rms_norm(x @ p["wdq"], p["q_ln"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(B, 1, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos[:, None], cfg.rope_theta)

    c_new = rms_norm(x @ p["wdkv"], p["kv_ln"], cfg.norm_eps)  # (B,1,r)
    kr_new = apply_rope((x @ p["wkr"])[:, :, None, :], pos[:, None],
                        cfg.rope_theta)[:, :, 0, :]            # (B,1,dr)

    _write_row(c_kv, at, c_new[:, 0])
    _write_row(k_rope, at, kr_new[:, 0])

    # absorb W_uk into q: q_lat[b,h,r] = sum_n q_nope[b,h,n] wuk[r,h*dn+n]
    wuk = p["wuk"].reshape(r, H, dn)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), wuk.float())
    scale = (dn + dr) ** -0.5
    ckv32 = c_kv.float()
    s = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv32)
         + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                        k_rope.float())) * scale
    valid = (s0 + torch.arange(S, device=x.device))[None, :] \
        <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    if axes:
        o_lat = _combine(s, lambda e: torch.einsum("bhqs,bsr->bqhr", e,
                                                   ckv32), dist, axes)
    else:
        o_lat = torch.einsum("bhqs,bsr->bqhr", torch.softmax(s, dim=-1),
                             ckv32)
    wuv = p["wuv"].reshape(r, H, dv)
    out = torch.einsum("bqhr,rhv->bqhv", o_lat, wuv.float())
    out = out.to(x.dtype).reshape(B, 1, H * dv)
    return out @ p["wo"], {"c_kv": c_kv, "k_rope": k_rope}


# ---------------------------------------------------------------------------
# Sequence-parallel decode (on a mesh)
# ---------------------------------------------------------------------------

def _seq_block(dist, axes, S_loc, pos, swa):
    """(this rank's first global row s0, the global rows S, the local
    slot of each row's new entry -- S_loc, past the block, where
    another rank writes it) of a cache whose sequence is cut into
    blocks of ``S_loc`` over ``axes``; a rolling window's slot is the
    global ``pos % S``."""
    S = S_loc * C.axes_size(dist, axes)
    s0 = C.axis_index(dist, axes) * S_loc
    slot = pos % S if swa else pos
    local = (slot >= s0) & (slot < s0 + S_loc)
    return s0, S, torch.where(local, slot - s0, S_loc)


def _combine(s, weigh, dist, axes):
    """softmax(s) applied by ``weigh`` over a sequence cut into blocks
    over ``axes``: each rank's partial max, denominator and weighted
    values (float32) combined by a ``pmax`` and two ``psum``s. s (B, H,
    1, S_loc); ``weigh(e)`` -> (B, 1, H, dv), e's weights on the rank's
    values; returns (B, 1, H, dv)."""
    m_glob = C.pmax(s.amax(dim=-1), dist, axes)          # (B, H, 1)
    e = torch.exp(s - m_glob[..., None])
    l_glob = C.psum(e.sum(dim=-1), dist, axes)
    acc = C.psum(weigh(e), dist, axes)
    return acc / torch.clamp(l_glob, min=1e-30).transpose(1, 2)[..., None]


def gqa_decode_sp(p, cfg, x, cache, pos, dist, axes=None):
    """One-token GQA decode with the KV cache's sequence cut into blocks
    over ``axes`` (the model axis when None; the data axes too where the
    batch does not divide them): the reference's ``gqa_decode_sp``.
    ``p``: the attention parameters the rank uses (whole, or its heads'
    under tensor parallelism, with ``cfg`` counting those heads); x (B,
    1, d) and pos (B,) this rank's batch rows; cache k/v (B, S_loc, Hkv,
    dh), this rank's sequence block (a rolling window's too: slot ``pos
    % S`` of the global S, every slot live once ``pos >= S - 1``).

    The rank whose block holds the new row's slot writes it there (a
    masked local write, in place); every rank computes a partial (max,
    denominator, weighted value) over its block, and the combine is a
    ``pmax`` and two ``psum``s over ``axes`` of (B, H) and (B, H, dh)
    values: the collective volume a layer is O(B H dh), not O(cache).
    Returns (out (B, 1, d), the cache in its sharded layout)."""
    axes = axes or dist.model_axis
    B = x.shape[0]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    kc, vc = cache["k"], cache["v"]
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    S_loc = kc.shape[1]
    s0, S, at = _seq_block(dist, axes, S_loc, pos, cfg.swa_window)
    _write_row(kc, at, k[:, 0])
    _write_row(vc, at, v[:, 0])

    kf, vf = _repeat_kv(kc, H // Hkv), _repeat_kv(vc, H // Hkv)
    s = torch.einsum("bqhd,bshd->bhqs", q.float() * dh ** -0.5, kf.float())
    idx = torch.arange(S_loc, device=x.device)
    valid = (s0 + idx)[None, :] <= pos[:, None]
    if cfg.swa_window:
        valid = valid | (pos[:, None] >= S - 1)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    vf = vf.float()
    out = _combine(s, lambda e: torch.einsum("bhqs,bshd->bqhd", e, vf),
                   dist, axes)
    out = out.to(x.dtype).reshape(B, 1, H * dh)
    return out @ p["wo"], {"k": kc, "v": vc}
