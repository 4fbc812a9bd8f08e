"""Model assembler: init / prefill / decode (counterpart of
``repro/models/model.py``) for every mixer (GQA or MLA attention,
Mamba, RWKV-6) and FFN (SwiGLU/GELU MLP or MoE) kind.

The reference scans one stacked copy of the layer parameters (prefix
layers, then periods of sublayers: jamba's period of 8, kimi-k2's dense
``prefix0``); here the stack is a list of per-layer parameter dicts in
model order and a Python loop runs it. Layer ``i`` of
``params["layers"]`` holds the reference's per-layer dict (``ln1``;
``attn``, ``mamba`` or ``rwkv``; ``ln2``; ``mlp`` or ``moe``), and the
cache mirrors it: ``cache["layers"][i]`` holds ``k``/``v`` (B, S, n_kv,
dh), MLA's ``c_kv``/``k_rope`` ((B, S, kv_lora), (B, S, rope)),
Mamba's ``conv``/``h`` or RWKV's ``att_shift``/``wkv``/``cm_shift``,
with the batch at axis 0. ``core/convert.py`` maps the reference's
stacked trees onto these.

Entry points:
    init_params(cfg, seed, device="cuda")        -> params
    init_cache(cfg, batch, cache_len, device=...) -> cache
    write_cache(cache, part, rows)                -> None (in place)
    prefill(cfg, params, batch, kernel_fns=None)  -> (last_logits, cache)
    decode_step(cfg, params, cache, token, pos, kernel_fns=None)
                                                  -> (logits, cache)
    train_loss(cfg, params, batch, kernel_fns=None)
                                  -> (loss, {"ce_loss", "aux_loss"})

``kernel_fns`` is ``kernels.ops.model_kernel_fns()`` to run attention
and wkv through the port's CUDA kernels; without it the plain versions
run. MLA decode, MoE and Mamba have no Pallas kernel in the reference
(XLA compiles them) and run here as PyTorch ops. The MoE aux loss is
dropped on this serving path, as the reference's ``prefill`` drops it;
``train_loss`` sums it over the layers. With ``cfg.remat`` (the full
configs) each layer of a training step is recomputed in the backward
(``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint(..., nothing_saveable)`` over a scanned period; here
the unit is a layer, the same arithmetic).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rw
from repro_torch.models.layers import (cross_entropy, embed_init, rms_norm,
                                       swiglu_apply, swiglu_init, unembed)


def layer_kinds(cfg) -> list[tuple[str, str]]:
    """(mixer, FFN) of every layer: mixer 'attn', 'mamba' or 'rwkv', FFN
    'mlp' or 'moe' (an rwkv layer carries its own channel mix)."""
    return [(cfg.layer_kind(i), cfg.ffn_kind(i))
            for i in range(cfg.n_layers)]


def stack_plan(cfg) -> tuple[int, int, int]:
    """(n_prefix, n_scan, period): how the reference stores the layers,
    ``n_prefix`` single layers then ``n_scan`` stacked copies of
    ``period`` sublayers (its ``_stack_plan``). Layer ``n_prefix + s
    period + j`` of the port is copy ``s`` of the reference's
    ``stack["sub<j>"]``."""
    if cfg.mamba is not None:
        return 0, cfg.n_layers // cfg.attn_period, cfg.attn_period
    if cfg.first_dense:
        return cfg.first_dense, cfg.n_layers - cfg.first_dense, 1
    return 0, cfg.n_layers, 1


def _layer_init(gen, cfg, kind, ffn, dtype):
    """One layer: mixer + FFN (rwkv carries its own channel mix)."""
    dev = gen.device
    p: dict[str, Any] = {"ln1": torch.ones((cfg.d_model,), dtype=dtype,
                                           device=dev)}
    if kind == "attn":
        p["attn"] = attn.attn_init(gen, cfg, dtype)
    elif kind == "mamba":
        p["mamba"] = mb.mamba_init(gen, cfg, dtype)
    else:
        p["rwkv"] = rw.rwkv_init(gen, cfg, dtype)
    p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if kind != "rwkv":
        if ffn == "moe":
            p["moe"] = moe_mod.moe_init(gen, cfg, dtype)
        else:
            p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                   cfg.mlp_variant)
    return p


def init_params(cfg, seed: int, device=None):
    """Random parameters in ``cfg.dtype`` (the router and Mamba's
    ``A_log``/``D`` in float32, as the reference), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA unless
    given)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = cfg.dtype
    params: dict[str, Any] = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                    dtype)
    params["layers"] = [_layer_init(gen, cfg, kind, ffn, dtype)
                        for kind, ffn in layer_kinds(cfg)]
    return params


def _layer_cache(cfg, kind, batch, cache_len, dtype, device):
    if kind == "attn":
        S = min(cache_len, cfg.swa_window) if cfg.swa_window else cache_len
        if cfg.attn_type == "mla":
            m = cfg.mla
            return {"c_kv": torch.zeros((batch, S, m.kv_lora_rank),
                                        dtype=dtype, device=device),
                    "k_rope": torch.zeros((batch, S, m.qk_rope_head_dim),
                                          dtype=dtype, device=device)}
        shape = (batch, S, cfg.n_kv, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "mamba":
        return mb.mamba_state_init(cfg, batch, device)
    return rw.rwkv_state_init(cfg, batch, dtype, device)


def init_cache(cfg, batch, cache_len, dtype=None, device=None):
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    return {"pos_offset": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev),
            "layers": [_layer_cache(cfg, kind, batch, cache_len, dtype, dev)
                       for kind, _ in layer_kinds(cfg)]}


def write_cache(cache, part, rows=slice(None)):
    """Copy the cache ``part`` (a prefill's) into batch ``rows`` of
    ``cache`` in place; a leaf shorter than the cache along an axis
    (the prompt's sequence of ``k``/``v`` or ``c_kv``/``k_rope``) lands
    at offset 0 of it; a state without a sequence axis (Mamba's, RWKV's)
    is copied whole."""
    cache["pos_offset"][rows] = part["pos_offset"]
    for dst, src in zip(cache["layers"], part["layers"]):
        for key, leaf in src.items():
            idx = (rows,) + tuple(slice(0, n) for n in leaf.shape[1:])
            dst[key][idx].copy_(leaf)


def _attn_layer(cfg, p, h, *, positions, kernel_fns, cache, pos,
                want_cache):
    mla = cfg.attn_type == "mla"
    if cache is not None and pos is not None:                  # decode
        decode = attn.mla_decode if mla else attn.gqa_decode
        return decode(p["attn"], cfg, h, cache, pos)
    forward = attn.mla_forward if mla else attn.gqa_forward
    out, rows = forward(p["attn"], cfg, h, positions=positions,
                        kernel_fn=kernel_fns.get("attention"))
    if not want_cache:
        return out, {}
    if mla:
        return out, dict(zip(("c_kv", "k_rope"), rows))
    k, v = rows
    if cfg.swa_window and k.shape[1] > cfg.swa_window:
        # roll the tail into a window-sized cache aligned so slot
        # (pos % window) matches gqa_decode's writes
        T, W = k.shape[1], cfg.swa_window
        k = torch.roll(k[:, -W:], T % W, dims=1)
        v = torch.roll(v[:, -W:], T % W, dims=1)
    return out, {"k": k, "v": v}


def _layer_apply(cfg, p, x, *, kind, ffn, positions, kernel_fns,
                 cache=None, pos=None, want_cache=False):
    """Returns (x, new_cache, aux): aux is the MoE FFN's auxiliary loss
    (float32 scalar), None for other FFNs."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "rwkv":
        st = cache or rw.rwkv_state_init(cfg, h.shape[0], h.dtype,
                                         h.device)
        out, att_shift, wkv = rw.time_mix(p["rwkv"], cfg, h,
                                          st["att_shift"], st["wkv"],
                                          kernel_fn=kernel_fns.get("wkv"))
        x = x + out
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        out2, cm_shift = rw.channel_mix(p["rwkv"], h2, st["cm_shift"])
        x = x + out2
        if want_cache or cache is not None:
            return x, {"att_shift": att_shift, "wkv": wkv,
                       "cm_shift": cm_shift}, None
        return x, {}, None
    if kind == "attn":
        out, new_cache = _attn_layer(cfg, p, h, positions=positions,
                                     kernel_fns=kernel_fns, cache=cache,
                                     pos=pos, want_cache=want_cache)
    else:
        out, state = mb.mamba_forward(p["mamba"], cfg, h, state=cache)
        new_cache = state if (want_cache or cache is not None) else {}
    x = x + out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = None
    if ffn == "moe":
        out2, aux = moe_mod.moe_apply(p["moe"], cfg, h2)
    else:
        out2 = swiglu_apply(p["mlp"], h2)
    return x + out2, new_cache, aux


def _run_stack(cfg, params, x, positions, kernel_fns, want_cache,
               in_cache=None, pos=None):
    """Applies every layer in order. Returns (x, per-layer caches)."""
    caches = []
    for i, ((kind, ffn), p) in enumerate(zip(layer_kinds(cfg),
                                             params["layers"])):
        x, c, _ = _layer_apply(cfg, p, x, kind=kind, ffn=ffn,
                               positions=positions,
                               kernel_fns=kernel_fns or {},
                               cache=in_cache[i] if in_cache else None,
                               pos=pos, want_cache=want_cache)   # aux dropped
        caches.append(c)
    return x, caches


def _train_stack(cfg, params, x, positions, kernel_fns):
    """Every layer in order for a training step, each recomputed in the
    backward when ``cfg.remat``. Returns (x, the MoE aux losses summed
    over the layers, float32)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (kind, ffn), p in zip(layer_kinds(cfg), params["layers"]):
        def layer(x, p, kind=kind, ffn=ffn):
            x, _, aux = _layer_apply(cfg, p, x, kind=kind, ffn=ffn,
                                     positions=positions,
                                     kernel_fns=kernel_fns)
            if aux is None:
                aux = torch.zeros((), dtype=torch.float32, device=x.device)
            return x, aux

        if cfg.remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                layer, x, p, use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = layer(x, p)
        aux_total = aux_total + aux
    return x, aux_total


def _embed_tokens(cfg, params, batch):
    if "features" in batch or "patches" in batch:
        raise NotImplementedError(
            f"{cfg.name}: the audio and vision frontends are not ported "
            "yet (ROADMAP Queue 1 item 13i)")
    # F.embedding: the same rows as indexing; its backward on the card
    # sums a token's rows in a fixed order (a training resume is
    # bit-exact)
    return F.embedding(batch["tokens"], params["embed"])


def _logits(cfg, params, x):
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return unembed(x, head)


def prefill(cfg, params, batch, kernel_fns=None):
    """batch["tokens"]: (B, T) int. Returns (float32 logits of the last
    position (B, padded_vocab), cache)."""
    x = _embed_tokens(cfg, params, batch)
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device)[None, :]
    x, caches = _run_stack(cfg, params, x, positions, kernel_fns,
                           want_cache=True)
    x = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    logits = _logits(cfg, params, x)
    pos_offset = torch.full((B,), T, dtype=torch.int32, device=x.device)
    return logits[:, 0], {"pos_offset": pos_offset, "layers": caches}


def train_loss(cfg, params, batch, kernel_fns=None):
    """The reference's ``train_loss``: batch["tokens"], batch["targets"]
    (B, T) int -> (cross entropy + 0.01 x the MoE aux loss, {"ce_loss",
    "aux_loss"}), float32 scalars. Differentiable through every layer;
    ``kernel_fns`` as ``prefill``'s (``ops.model_kernel_fns()`` runs the
    CUDA kernels' forwards and backwards on the card)."""
    x = _embed_tokens(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = _train_stack(cfg, params, x, positions, kernel_fns or {})
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = cross_entropy(_logits(cfg, params, x), batch["targets"])
    return loss + 0.01 * aux, {"ce_loss": loss, "aux_loss": aux}


def decode_step(cfg, params, cache, token, pos, kernel_fns=None):
    """token: (B,1) int; pos: (B,) absolute position of ``token``. The
    attention caches are updated in place (see ``gqa_decode`` and
    ``mla_decode``); the recurrent states come back as new tensors."""
    x = params["embed"][token]
    x, caches = _run_stack(cfg, params, x, pos[:, None], kernel_fns,
                           want_cache=False, in_cache=cache["layers"],
                           pos=pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(cfg, params, x)
    return logits[:, 0], {"pos_offset": pos + 1, "layers": caches}
