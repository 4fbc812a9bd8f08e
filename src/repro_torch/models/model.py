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
    prefill(cfg, params, batch, kernel_fns=None, dist=None)
                                                  -> (last_logits, cache)
        batch: tokens (B, T); hubert's features (B, T, d_model) [+ mask,
        targets]; internvl's patches (B, P, d_model) + tokens
    decode_step(cfg, params, cache, token, pos, kernel_fns=None,
                dist=None)                        -> (logits, cache)
    train_loss(cfg, params, batch, kernel_fns=None, dist=None)
                                  -> (loss, {"ce_loss", "aux_loss"})
        batch: prefill's, with targets (and a frontend's loss mask)

With ``dist`` (a ``models.moe.DistContext`` on a mesh) each rank holds
its blocks of the parameters (``distributed.sharding.param_specs``)
and of a cache (``decode_cache_specs``, the reference's
``cache_specs``) and takes the global batch: the rows are split over
the data axes (FSDP gathers each layer's blocks at use) and Megatron
tensor parallelism runs over 'model' wherever the layout divides it:
GQA attention's heads (a forward, and a decode whose cache holds the
rank's kv heads), the MLP's d_ff, RWKV's heads, Mamba's channels, and
the vocab of the head (and of a tied table: its lookup too); the MoE
runs ``moe_apply_dist``. A decode attends over the rank's cache block
as it is (its kv heads, or its sequence block with a partial softmax
combined over the sequence's axes) and prefill hands back each rank's
block; a part the layout does not divide runs alike on every rank of
'model' with its weights gathered whole (MLA, a GQA layer whose heads
do not divide the axis, the norms, an untied embedding).

Between layers the residual stream is the rank's block of
``distributed.sharding.act_spec`` (the reference's ``_constrain_act``):
under ``act_shard == "dmodel"`` (every config's default) its 1/m block of
d, under ``"seq"`` of the sequence, under ``"none"`` whole. Each
sublayer gathers it whole before its norm (``_norm_in``) and hands its
output back in that layout (``_out``): a tensor-parallel part's partial
sums reduce-scattered into the block (summed whole under ``"none"``), a
whole output cut to it. With remat a layer saves its input, the block.

The batch of each cell is ``configs.input_specs``'s: the audio and
vision frontends are stubs, as in the reference (precomputed frame or
patch embeddings); ``decode_step`` embeds a token whatever the
frontend.

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

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rw
from repro_torch.models.layers import (embed_init, gathered_rms_norm,
                                       masked_mean, nll, rms_norm,
                                       swiglu_apply, swiglu_init, unembed,
                                       vocab_parallel_nll)


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


class _MetaGenerator(torch.Generator):
    """A generator the initialisers draw from on the ``meta`` device
    (shapes and dtypes only: ``distributed.sharding``'s specs)."""

    @property
    def device(self):
        return torch.device("meta")


def init_params(cfg, seed: int, device=None, dist=None):
    """Random parameters in ``cfg.dtype`` (the router and Mamba's
    ``A_log``/``D`` in float32, as the reference), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA unless
    given).

    On a mesh (``dist``) the rank's blocks (``distributed.sharding
    .param_specs``) of the same draws: each top-level leaf and each layer
    is cut to its blocks as soon as it is drawn, so no more than one of
    them is ever whole on the device."""
    dist = moe_mod.as_dist(dist, "init_params")
    dev = resolve_device(device)
    gen = _MetaGenerator() if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    specs = _param_specs(cfg, dist) if dist is not None else None

    def place(x, spec):
        return x if dist is None else shd.shard_tree(x, spec, dist)

    dtype = cfg.dtype
    params: dict[str, Any] = {
        "embed": place(embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
                       specs and specs["embed"]),
        "final_norm": place(torch.ones((cfg.d_model,), dtype=dtype,
                                       device=dev),
                            specs and specs["final_norm"]),
    }
    if not cfg.tie_embeddings:
        params["head"] = place(embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                          dtype), specs and specs["head"])
    params["layers"] = [place(_layer_init(gen, cfg, kind, ffn, dtype),
                              specs and specs["layers"][i])
                        for i, (kind, ffn) in enumerate(layer_kinds(cfg))]
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


def _use(p, specs, name, dist, **kw):
    """Leaf ``name`` of ``p`` as a layer uses it: on one device the
    tensor; on a mesh the rank's block gathered (``gather_param``)."""
    if dist is None:
        return p[name]
    return C.gather_param(p[name], dist, specs[name], **kw)


def _whole(p, specs, dist):
    """Every leaf of ``p`` gathered whole (a part every rank of 'model'
    runs alike: MLA, norms, a part the layout does not divide)."""
    if dist is None:
        return p
    return {k: _whole(v, specs[k], dist) if isinstance(v, dict) else
            C.gather_param(v, dist, specs[k]) for k, v in p.items()}


_RWKV_PARTIAL = ("maa_x", "maa_wkvrg", "tm_w1", "tm_w2", "w0", "td_w1",
                 "td_w2", "u", "gn_w", "cm_maa_k", "cm_maa_r", "cm_wr")

#: Megatron tensor parallelism over 'model': how a tensor-parallel part
#: uses each leaf of its block -- "keep": the rank's 'model' block of a
#: column- (wq, w_gate, w_up, rwkv's wr, Mamba's in_proj) or row-parallel
#: (wo, w_down, Mamba's out_proj) product, or of a per-head or
#: per-channel leaf; "partial": replicated over 'model' but used by the
#: rank for its part only (the kv heads its q heads read, rwkv's
#: replicated loras feeding its heads, its columns of the channel mix's
#: receptance), its gradient summed over 'model'.
TP_USE = {"attn": {"wq": "keep", "wo": "keep", "wk": "partial",
                   "wv": "partial", "q_norm": "partial",
                   "k_norm": "partial"},
          "mlp": {"w_gate": "keep", "w_up": "keep", "w_down": "keep"},
          "rwkv": dict({k: "keep" for k in ("wr", "wk", "wv", "wg", "wo",
                                             "cm_wk", "cm_wv")},
                       **{k: "partial" for k in _RWKV_PARTIAL}),
          "mamba": {k: "keep" for k in ("in_proj", "conv_w", "conv_b",
                                        "x_proj", "dt_proj", "dt_bias",
                                        "A_log", "D", "out_proj")}}


def tp_attention(cfg, dist) -> bool:
    """Whether an attention layer's forward (not a decode step) splits
    its heads over 'model': GQA whose heads divide the axis."""
    return dist is not None and cfg.attn_type != "mla" and \
        cfg.n_heads % dist.model_size == 0


def tp_mlp(cfg, dist) -> bool:
    """Whether the dense FFN is tensor-parallel over 'model': d_ff
    divides the axis."""
    return dist is not None and cfg.d_ff % dist.model_size == 0


def tp_rwkv(cfg, dist) -> bool:
    """Whether an RWKV layer splits its heads over 'model' (the heads
    divide the axis)."""
    return dist is not None and \
        (cfg.d_model // cfg.rwkv_head_dim) % dist.model_size == 0


def tp_mamba(cfg, dist) -> bool:
    """Whether a Mamba layer splits its channels over 'model' (d_in
    divides the axis; its blocks exist only then)."""
    return dist is not None and \
        mb.mamba_dims(cfg)[0] % dist.model_size == 0


def vocab_parallel(cfg, dist) -> bool:
    """Whether the head (and a tied table) keep their vocab block over
    'model' (``sharding.logits_spec``'s condition: the padded vocab
    divides the axis): each rank computes its block of the logits."""
    return dist is not None and cfg.padded_vocab % dist.model_size == 0


def _tp_leaves(p, specs, dist, part):
    """The leaves of a tensor-parallel part (``TP_USE[part]``) as the
    rank uses them: gathered over every axis, but 'model' kept for a
    "keep" leaf and its gradient summed over 'model' for a "partial"
    one."""
    ma = dist.model_axis
    return {k: C.gather_param(v, dist, specs[k], **{TP_USE[part][k]: ma})
            for k, v in p.items()}


def tp_kv_heads(cfg, model_size, r):
    """The kv heads rank ``r`` of 'model' computes for its q heads
    [r H / m, (r + 1) H / m): a ``range`` when its q heads are whole
    groups, else one kv head a q head (a group split between ranks)."""
    H, g = cfg.n_heads, cfg.n_heads // cfg.n_kv
    lo, hi = r * H // model_size, (r + 1) * H // model_size
    if lo % g == 0 and (hi - lo) % g == 0:
        return range(lo // g, hi // g)
    return [h // g for h in range(lo, hi)]


def _attn_tp(cfg, p, specs, dist, device):
    """(the rank's attention weights, the config of its heads) under
    tensor parallelism over 'model' (H % model == 0):
    ``wq``'s column block, the columns of ``wk``/``wv`` of the kv heads
    its q heads read (replicated over 'model'), its ``wo`` row block."""
    m, dh = dist.model_size, cfg.d_head
    w = _tp_leaves(p, specs, dist, "attn")
    kv = tp_kv_heads(cfg, m, C.axis_index(dist, dist.model_axis))
    cols = slice(kv[0] * dh, (kv[-1] + 1) * dh) if isinstance(kv, range) \
        else torch.tensor([j * dh + i for j in kv for i in range(dh)],
                          device=device)
    w["wk"], w["wv"] = w["wk"][:, cols], w["wv"][:, cols]
    return w, dataclasses.replace(cfg, n_heads=cfg.n_heads // m,
                                  n_kv=len(kv))


def _gqa_tp(cfg, p, specs, h, *, positions, kernel_fn, dist, want_cache,
            kv_local):
    """``attn.gqa_forward`` with its heads split over 'model' (H %
    model == 0): the rank runs its q heads, the kv heads they read and
    its ``wo`` row block. Returns (its partial output (``_out`` sums
    it), with ``want_cache`` the (k, v) rows: the rank's own kv heads
    with ``kv_local`` (a block of 'model': n_kv divides it), else every
    kv head, gathered over 'model'; None without)."""
    ma, m = dist.model_axis, dist.model_size
    w, local = _attn_tp(cfg, p, specs, dist, h.device)
    out, (k, v) = attn.gqa_forward(w, local, h, positions=positions,
                                   kernel_fn=kernel_fn)
    if not want_cache:
        return out, None
    if kv_local:
        return out, (k, v)
    # each kv head from the first rank that computed it
    order = [j for r in range(m) for j in tp_kv_heads(cfg, m, r)]
    first = torch.tensor([order.index(j) for j in range(cfg.n_kv)],
                         device=h.device)
    return out, tuple(
        C.all_gather(t, dist, ma, 2, replicated=True).index_select(2, first)
        for t in (k, v))


def _cut_seq(rows, cspec, dist):
    """A prefill's cache rows (the rank's batch rows, its heads where
    the layout keeps them) cut to the layout's sequence block."""
    return {k: shd.block(t, (None, cspec[k][1]), dist).contiguous()
            for k, t in rows.items()}


def _attn_decode(cfg, p, specs, h, cache, pos, dist, cspec):
    """One decode step of an attention layer on its cache (the rank's
    block on a mesh, laid out by ``cspec``, ``decode_cache_specs``'),
    never gathered: GQA on the rank's kv heads (``decode_kv_heads``: its
    q heads and ``wo`` row block, a partial output) and/or over its
    sequence block (``gqa_decode_sp`` over the sequence's axes); MLA
    over its latent rows (``mla_decode`` over the same)."""
    mla = cfg.attn_type == "mla"
    if dist is None:
        return (attn.mla_decode if mla else attn.gqa_decode)(
            p, cfg, h, cache, pos)
    seq = cspec["c_kv" if mla else "k"][1]
    if mla:
        return attn.mla_decode(_whole(p, specs, dist), cfg, h, cache, pos,
                               dist, seq)
    if cspec["k"][2] is not None:                   # the rank's kv heads
        w, local = _attn_tp(cfg, p, specs, dist, h.device)
    else:
        w, local = _whole(p, specs, dist), cfg
    if seq is None:
        return attn.gqa_decode(w, local, h, cache, pos)
    return attn.gqa_decode_sp(w, local, h, cache, pos, dist, seq)


def _attn_layer(cfg, p, specs, h, *, positions, kernel_fns, cache, pos,
                want_cache, dist, cspec):
    mla = cfg.attn_type == "mla"
    sp = specs and specs["attn"]
    if cache is not None and pos is not None:                  # decode
        return _attn_decode(cfg, p["attn"], sp, h, cache, pos, dist, cspec)
    if tp_attention(cfg, dist):
        out, rows = _gqa_tp(cfg, p["attn"], sp, h, positions=positions,
                            kernel_fn=kernel_fns.get("attention"),
                            dist=dist, want_cache=want_cache,
                            kv_local=want_cache and
                            cspec["k"][2] is not None)
    else:
        forward = attn.mla_forward if mla else attn.gqa_forward
        out, rows = forward(_whole(p["attn"], sp, dist), cfg, h,
                            positions=positions,
                            kernel_fn=kernel_fns.get("attention"))
    if not want_cache:
        return out, {}
    if mla:
        rows = dict(zip(("c_kv", "k_rope"), rows))
    else:
        k, v = rows
        if cfg.swa_window and k.shape[1] > cfg.swa_window:
            # roll the tail into a window-sized cache aligned so slot
            # (pos % window) matches gqa_decode's writes
            T, W = k.shape[1], cfg.swa_window
            k = torch.roll(k[:, -W:], T % W, dims=1)
            v = torch.roll(v[:, -W:], T % W, dims=1)
        rows = {"k": k, "v": v}
    if dist is not None:
        rows = _cut_seq(rows, cspec, dist)
    return out, rows


def _mlp(cfg, p, specs, h, dist):
    """The dense FFN; on a mesh column-parallel ``w_gate``/``w_up`` and
    row-parallel ``w_down`` over 'model' (their d_ff blocks), a partial
    output (Megatron), when d_ff divides the axis."""
    if not tp_mlp(cfg, dist):
        return swiglu_apply(_whole(p, specs, dist), h)
    return swiglu_apply(_tp_leaves(p, specs, dist, "mlp"), h)


def _rwkv_layer(cfg, p, specs, x, h, st, kernel_fn, norm2, dist, act):
    """An RWKV layer's time mix and channel mix on the residual x (h the
    time mix's normed input, ``norm2`` the channel mix's from a
    residual): on a mesh whose 'model' axis divides the heads, the
    rank's heads (their column blocks, the wkv kernel on them, the
    state's head block) with ``wo``'s row block (a partial output), and
    the channel mix's ``cm_wk`` column and ``cm_wv`` row blocks, their
    partial sums reduce-scattered to the rank's block of d_model, its
    columns of the receptance (``_from_d_block`` lays that block out).
    Returns (x, att_shift, wkv state, cm_shift)."""
    if not tp_rwkv(cfg, dist):
        prw = _whole(p, specs, dist)
        st = st or rw.rwkv_state_init(cfg, h.shape[0], h.dtype, h.device)
        out, att_shift, wkv = rw.time_mix(prw, cfg, h, st["att_shift"],
                                          st["wkv"], kernel_fn=kernel_fn)
        x = x + _out(out, dist, act, False)
        out2, cm_shift = rw.channel_mix(prw, norm2(x), st["cm_shift"])
        return x + _out(out2, dist, act, False), att_shift, wkv, cm_shift
    ma, m = dist.model_axis, dist.model_size
    w = _tp_leaves(p, specs, dist, "rwkv")
    n = cfg.d_model // cfg.rwkv_head_dim // m
    r0 = C.axis_index(dist, ma) * n
    st = st or rw.rwkv_state_init(cfg, h.shape[0], h.dtype, h.device,
                                  n_heads=n)
    out, att_shift, wkv = rw.time_mix(w, cfg, h, st["att_shift"], st["wkv"],
                                      kernel_fn=kernel_fn,
                                      heads=slice(r0, r0 + n))
    x = x + _out(out, dist, act, True)
    d = cfg.d_model // m
    c0 = C.axis_index(dist, ma) * d
    out2, cm_shift = rw.channel_mix(
        w, norm2(x), st["cm_shift"],
        tp=(slice(c0, c0 + d), lambda t: C.psum_scatter(t, dist, ma, 2),
            lambda t: _from_d_block(t, dist, act)))
    return x + out2, att_shift, wkv, cm_shift


def _mamba_layer(cfg, p, specs, h, state, dist):
    """A Mamba mixer: on a mesh the rank's channels (``tp_mamba``), the
    x_proj partial products summed over 'model' (and their gradient,
    which each rank's channels use), ``out_proj``'s row block (a partial
    output)."""
    if not tp_mamba(cfg, dist):
        return mb.mamba_forward(_whole(p, specs, dist), cfg, h, state=state)
    ma = dist.model_axis
    return mb.mamba_forward(
        _tp_leaves(p, specs, dist, "mamba"), cfg, h, state=state,
        reduce=lambda t: C.copy_to(C.psum(t, dist, ma), dist, ma))


def act_dim(cfg, dist, shape):
    """The dimension of the residual (global ``shape`` (B, T, d)) that
    'model' cuts between layers (``sharding.act_spec``): 1 under
    ``"seq"``, 2 under ``"dmodel"``, None whole (and without a mesh, or
    on a 'model' axis of one rank, whose block is the whole)."""
    if dist is None or dist.model_size == 1:
        return None
    spec = shd.act_spec(cfg, dist, shape)
    return next((i for i in (1, 2) if spec[i] is not None), None)


def _norm_in(cfg, p, specs, name, x, dist, act, tp):
    """A sublayer's normed input (norm ``name`` of ``p``) from the
    residual x. On a mesh x is the rank's block of dimension ``act``
    over 'model', gathered whole first, as GSPMD gathers before the
    norm. Its transpose depends on the consumer: a tensor-parallel part
    (``tp``: each rank computes its share of the output from it) hands
    back a different partial gradient on each rank, which the backward
    reduce-scatters into the block before the norm's
    (``layers.gathered_rms_norm``); a part every rank computes alike
    takes its block of the gradient. With the residual whole (``act``
    None) a tensor-parallel part's input is ``copy_to``'s (Megatron's
    f)."""
    if dist is None:
        return rms_norm(x, p[name], cfg.norm_eps)
    ma, gain = dist.model_axis, _use(p, specs, name, dist)
    if act is None:
        h = rms_norm(x, gain, cfg.norm_eps)
        return C.copy_to(h, dist, ma) if tp else h
    if tp:
        return gathered_rms_norm(x, gain, cfg.norm_eps, dist, ma, act)
    return rms_norm(_gathered(x, dist, act), gain, cfg.norm_eps)


def _out(y, dist, act, tp):
    """A sublayer's output in the residual's layout: a tensor-parallel
    part's partial output (``tp``) reduce-scattered into the rank's
    block of dimension ``act`` (summed whole when ``act`` is None,
    Megatron's g); a whole output (every rank computed it alike) cut to
    the block."""
    if dist is None:
        return y
    ma = dist.model_axis
    if act is None:
        return C.psum(y, dist, ma) if tp else y
    return C.psum_scatter(y, dist, ma, act) if tp else \
        C.scatter(y, dist, ma, act)


def _gathered(x, dist, act):
    """The whole residual from the rank's block (every rank then holds
    it alike)."""
    if act is None:
        return x
    return C.all_gather(x, dist, dist.model_axis, act, replicated=True)


def _from_d_block(y, dist, act):
    """An output already summed into the rank's block of d (the
    ``psum_scatter`` MoE combine, RWKV's channel mix) in the residual's
    layout: that block under ``"dmodel"``, else gathered and laid out
    as ``_out`` lays a whole output."""
    if act == 2:
        return y
    return _out(_gathered(y, dist, 2), dist, act, False)


def tp_mixer(cfg, dist, kind, decode) -> bool:
    """Whether a layer's mixer is tensor-parallel over 'model' (its
    output a partial sum): attention's heads (a decode's: the cache's kv
    heads, ``decode_kv_heads``), RWKV's heads, Mamba's channels."""
    if dist is None:
        return False
    if kind == "attn":
        return shd.decode_kv_heads(cfg, dist) if decode else \
            tp_attention(cfg, dist)
    return (tp_rwkv if kind == "rwkv" else tp_mamba)(cfg, dist)


def _layer_apply(cfg, p, x, *, kind, ffn, positions, kernel_fns,
                 cache=None, pos=None, want_cache=False, dist=None,
                 specs=None, split=True, cspec=None, act=None):
    """Returns (x, new_cache, aux): aux is the MoE FFN's auxiliary loss
    (float32 scalar), None for other FFNs. On a mesh (``dist``) ``p``
    holds the rank's blocks laid out by ``specs``; x, in and out, is the
    rank's block of the residual: its batch rows (``split``: a block of
    a batch split over the data axes), cut over 'model' on dimension
    ``act`` (``act_dim``; None: whole). Each sublayer gathers it whole
    before its norm (``_norm_in``) and adds its output in the same
    layout (``_out``); the cache is the rank's block laid out by
    ``cspec`` (and so is the new cache)."""
    tp = tp_mixer(cfg, dist, kind, cache is not None and pos is not None)
    h = _norm_in(cfg, p, specs, "ln1", x, dist, act, tp)
    if kind == "rwkv":
        x, att_shift, wkv, cm_shift = _rwkv_layer(
            cfg, p["rwkv"], specs and specs["rwkv"], x, h, cache,
            kernel_fns.get("wkv"),
            lambda y: _norm_in(cfg, p, specs, "ln2", y, dist, act, tp),
            dist, act)
        if want_cache or cache is not None:
            return x, {"att_shift": att_shift, "wkv": wkv,
                       "cm_shift": cm_shift}, None
        return x, {}, None
    if kind == "attn":
        out, new_cache = _attn_layer(cfg, p, specs, h, positions=positions,
                                     kernel_fns=kernel_fns, cache=cache,
                                     pos=pos, want_cache=want_cache,
                                     dist=dist, cspec=cspec)
    else:
        out, state = _mamba_layer(cfg, p["mamba"], specs and specs["mamba"],
                                  h, cache, dist)
        new_cache = state if (want_cache or cache is not None) else {}
    x = x + _out(out, dist, act, tp)
    tp = ffn == "mlp" and tp_mlp(cfg, dist)
    h2 = _norm_in(cfg, p, specs, "ln2", x, dist, act, tp)
    aux = None
    if ffn == "moe" and dist is not None:
        out2, aux = moe_mod.moe_apply_dist(p["moe"], cfg, h2, dist,
                                           split=split)
        out2 = _from_d_block(out2, dist, act) if \
            moe_mod.combine_scatters(cfg, dist) else \
            _out(out2, dist, act, False)
    elif ffn == "moe":
        out2, aux = moe_mod.moe_apply(p["moe"], cfg, h2)
    else:
        out2 = _out(_mlp(cfg, p["mlp"], specs and specs["mlp"], h2, dist),
                    dist, act, tp)
    return x + out2, new_cache, aux


def _constrain_act(x, dist, act):
    """The residual stream as the reference constrains it between layers
    (``_constrain_act``, ``sharding.act_spec``): the rank's block over
    'model' of dimension ``act`` of an x every rank of 'model' holds
    alike (the embedding's output), laid out as ``_out`` lays a whole
    output. The layers take and return that block."""
    return _out(x, dist, act, False)


def _run_stack(cfg, params, x, positions, kernel_fns, want_cache,
               in_cache=None, pos=None, dist=None, specs=None, split=True,
               cspecs=None, act=None):
    """Applies every layer in order to the residual (on a mesh the
    rank's block, ``_layer_apply``). Returns (x, per-layer caches); on
    a mesh the caches are the rank's blocks laid out by ``cspecs``."""
    caches = []
    for i, ((kind, ffn), p) in enumerate(zip(layer_kinds(cfg),
                                             params["layers"])):
        x, c, _ = _layer_apply(cfg, p, x, kind=kind, ffn=ffn,
                               positions=positions,
                               kernel_fns=kernel_fns or {},
                               cache=in_cache[i] if in_cache else None,
                               pos=pos, want_cache=want_cache, dist=dist,
                               specs=specs and specs["layers"][i],
                               split=split, cspec=cspecs and cspecs[i],
                               act=act)                     # aux dropped
        caches.append(c)
    return x, caches


def _train_stack(cfg, params, x, positions, kernel_fns, dist=None,
                 specs=None, split=True, act=None):
    """Every layer in order for a training step, each recomputed in the
    backward when ``cfg.remat`` (on a mesh its parameter gathers and its
    residual's gathers too, as the reference's remat recomputes its
    FSDP all-gathers): what a layer keeps for the backward is its input,
    on a mesh the rank's block of the residual. Returns (x, the MoE aux
    losses summed over the layers, float32)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, ((kind, ffn), p) in enumerate(zip(layer_kinds(cfg),
                                             params["layers"])):
        def layer(x, p, kind=kind, ffn=ffn,
                  sp=specs and specs["layers"][i]):
            x, _, aux = _layer_apply(cfg, p, x, kind=kind, ffn=ffn,
                                     positions=positions,
                                     kernel_fns=kernel_fns, dist=dist,
                                     specs=sp, split=split, act=act)
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


def _embed_inputs(cfg, embed, batch):
    """(x, positions, targets, loss mask) of a batch, the reference's
    ``_embed_inputs`` branch for branch (``embed``: token ids -> their
    embeddings, ``_lookup``):

    * ``audio_frames``: x is ``batch["features"]`` (B, T, d_model) as
      given, in ``cfg.dtype`` (``configs.input_specs``); targets and
      mask are ``batch.get``'s;
    * ``vision_patches`` with ``batch["patches"]`` (B, P, d_model), P =
      ``cfg.n_frontend_tokens``: the patches (cast to the embedding's
      dtype) before the tokens' embeddings; given targets, they gain P
      zeros in front and the mask is False over the patches;
    * otherwise the tokens' embeddings (``F.embedding``: the same rows
      as indexing; its backward on the card sums a token's rows in a
      fixed order, so a training resume is bit-exact)."""
    if cfg.frontend == "audio_frames":
        if "features" not in batch:
            raise ValueError(f"{cfg.name}: an audio_frames batch needs "
                             f"'features' (B, T, {cfg.d_model}), got keys "
                             f"{sorted(batch)}")
        x = batch["features"]
        if x.dtype != cfg.dtype:
            # the reference promotes float32 features against bf16
            # weights and runs the residual stream in float32: a cast
            # here would compute something else
            raise ValueError(f"{cfg.name}: features must be {cfg.dtype}, "
                             f"as configs.input_specs declares them; got "
                             f"{x.dtype}")
        T = x.shape[1]
        return (x, torch.arange(T, device=x.device)[None, :],
                batch.get("targets"), batch.get("mask"))
    if cfg.frontend == "vision_patches" and "patches" in batch:
        patches = batch["patches"]
        P = cfg.n_frontend_tokens
        if patches.dim() != 3 or patches.shape[1] != P:
            raise ValueError(f"{cfg.name}: patches must be (B, {P}, "
                             f"{cfg.d_model}) (n_frontend_tokens = {P}), "
                             f"got {tuple(patches.shape)}")
        tok_emb = embed(batch["tokens"])
        x = torch.cat([patches.to(tok_emb.dtype), tok_emb], dim=1)
        B, T = x.shape[:2]
        positions = torch.arange(T, device=x.device)[None, :]
        tgt, mask = batch.get("targets"), None
        if tgt is not None:
            tgt = torch.cat([tgt.new_zeros((B, P)), tgt], dim=1)
            mask = (positions >= P).expand(B, T)
        return x, positions, tgt, mask
    x = embed(batch["tokens"])
    return (x, torch.arange(x.shape[1], device=x.device)[None, :],
            batch.get("targets"), None)


# ---------------------------------------------------------------------------
# On a mesh: the entry points take the global batch (the same on every
# rank) and the rank's parameter and cache blocks
# ---------------------------------------------------------------------------

def _local_rows(batch, dist):
    """(split, the rank's rows of every leaf): the batch is split over
    the data axes when its size divides them, else every rank keeps it
    whole (the reference's replicated-batch case)."""
    B = next(iter(batch.values())).shape[0]
    if B % dist.data_size:
        return False, dict(batch)
    spec = (C.spec_entry(dist.data_axes),)
    return True, {k: shd.block(v, spec, dist) for k, v in batch.items()}


def _rows_whole(t, dist, split):
    """Every rank's rows of ``t`` gathered in batch order."""
    return shd.unblock(t, (C.spec_entry(dist.data_axes),), dist) if split \
        else t


def _table(cfg, params, specs, dist, name):
    """The embedding table or head (``name``) as the rank uses it: its
    vocab block over 'model' where ``vocab_parallel`` (the head, and
    the table when tied), else gathered whole."""
    if (name == "head" or cfg.tie_embeddings) and \
            vocab_parallel(cfg, dist):
        return C.gather_param(params[name], dist, specs[name],
                              keep=dist.model_axis)
    return _use(params, specs, name, dist)


def _lookup(cfg, table, tokens, dist):
    """The embeddings of ``tokens`` from the rank's table: on a tied
    vocab-parallel table (the rank's vocab block) the rows of its block,
    zeros elsewhere, summed over 'model' (its gradient reaches the rows
    of each rank's block)."""
    if not (cfg.tie_embeddings and vocab_parallel(cfg, dist)):
        return F.embedding(tokens, table)
    V = table.shape[0]
    ids = tokens - C.axis_index(dist, dist.model_axis) * V
    inside = (ids >= 0) & (ids < V)
    x = F.embedding(ids.clamp(0, V - 1), table)
    return C.psum(x.masked_fill(~inside[..., None], 0), dist,
                  dist.model_axis)


def _top(cfg, params, specs, dist):
    """(embedding table, final norm, head) as the rank uses them
    (``_table``)."""
    emb = _table(cfg, params, specs, dist, "embed")
    head = emb if cfg.tie_embeddings else \
        _table(cfg, params, specs, dist, "head")
    return emb, _use(params, specs, "final_norm", dist), head


def _last_normed(cfg, x, final_norm, dist, act):
    """The last position of the residual (on a mesh the rank's block,
    gathered: under ``"dmodel"`` only that position's block), normed:
    (b, 1, d)."""
    if act != 1:
        x = x[:, -1:]
    return rms_norm(_gathered(x, dist, act)[:, -1:], final_norm,
                    cfg.norm_eps)


def _last_logits(cfg, x, head, dist, split):
    """Float32 logits (B, padded_vocab) of x (b, 1, d), the last
    position, whole on every rank: a vocab-parallel head's blocks
    gathered over 'model', the rows over the data axes."""
    logits = unembed(x, head)[:, 0]
    if dist is None:
        return logits
    if vocab_parallel(cfg, dist):
        logits = C.all_gather(logits, dist, dist.model_axis, 1,
                              replicated=True)
    return _rows_whole(logits, dist, split)


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient scaled."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _dist_cross_entropy(nll_, mask, dist, split):
    """The mean of the positions' negative log-likelihoods ``nll_`` over
    the global batch from the rank's rows: the mean of the ranks' means
    (each rank holds as many positions), or under a loss mask the masked
    sums over every rank."""
    if not split:
        return masked_mean(nll_, mask)
    da = dist.data_axes
    if mask is None:
        return C.psum(torch.mean(nll_), dist, da) / dist.data_size
    mask = mask.float()
    return C.psum(torch.sum(nll_ * mask), dist, da) / \
        torch.clamp(C.psum(torch.sum(mask), dist, da), min=1.0)


def prefill(cfg, params, batch, kernel_fns=None, dist=None):
    """batch: ``tokens`` (B, T) int, or a frontend's inputs (see
    ``_embed_inputs``). Returns (float32 logits of the last position
    (B, padded_vocab), cache); the cache's ``pos_offset`` is the whole
    sequence's length, patches included.

    On a mesh (``dist``): ``params`` are the rank's blocks
    (``distributed.sharding.param_specs``), ``batch`` the global batch;
    the logits come back whole on every rank (a vocab-parallel head's
    blocks gathered), the cache as the rank's blocks laid out by
    ``distributed.sharding.decode_cache_specs`` (a layer's rows are
    whole only while they are cut)."""
    dist = moe_mod.as_dist(dist, "prefill")
    specs, split, B = None, True, None
    if dist is not None:
        specs = _param_specs(cfg, dist)
        B = next(iter(batch.values())).shape[0]
        split, batch = _local_rows(batch, dist)
    emb, final_norm, head = _top(cfg, params, specs, dist)
    x, positions, _, _ = _embed_inputs(
        cfg, lambda t: _lookup(cfg, emb, t, dist), batch)
    b, T = x.shape[:2]
    cspecs = shd.decode_cache_specs(cfg, B, T, dist)["layers"] \
        if dist is not None else None
    act = act_dim(cfg, dist, (B, T, x.shape[2]))
    x, caches = _run_stack(cfg, params, _constrain_act(x, dist, act),
                           positions, kernel_fns, want_cache=True,
                           dist=dist, specs=specs, split=split,
                           cspecs=cspecs, act=act)
    x = _last_normed(cfg, x, final_norm, dist, act)
    logits = _last_logits(cfg, x, head, dist, split)
    pos_offset = torch.full((b,), T, dtype=torch.int32, device=x.device)
    return logits, {"pos_offset": pos_offset, "layers": caches}


def train_loss(cfg, params, batch, kernel_fns=None, dist=None):
    """The reference's ``train_loss``: a batch of ``tokens`` and
    ``targets`` (B, T) int, or a frontend's (``features``, ``mask``,
    ``targets``; ``patches``, ``tokens``, ``targets``) -> (cross
    entropy over the loss mask + 0.01 x the MoE aux loss, {"ce_loss",
    "aux_loss"}), float32 scalars. Differentiable through every layer;
    ``kernel_fns`` as ``prefill``'s (``ops.model_kernel_fns()`` runs the
    CUDA kernels' forwards and backwards on the card).

    On a mesh (``dist``): ``params`` are the rank's blocks, ``batch``
    the global batch; the loss is the global batch's on every rank, and
    the gradient of each block (autograd's, through the collectives'
    transposes) is the block of the one-device gradient. A
    vocab-parallel head (``vocab_parallel``) gives each rank its block
    of the logits, (b, T, V / m), and the loss is
    ``layers.vocab_parallel_nll``'s."""
    dist = moe_mod.as_dist(dist, "train_loss")
    specs, split, B = None, True, None
    if dist is not None:
        specs = _param_specs(cfg, dist)
        B = next(iter(batch.values())).shape[0]
        split, batch = _local_rows(batch, dist)
    emb = _table(cfg, params, specs, dist, "embed")
    x, positions, targets, mask = _embed_inputs(
        cfg, lambda t: _lookup(cfg, emb, t, dist), batch)
    if not cfg.tie_embeddings:
        emb = None         # on a mesh: the gathered table freed at once
    act = act_dim(cfg, dist, (B,) + tuple(x.shape[1:]))
    x, aux = _train_stack(cfg, params, _constrain_act(x, dist, act),
                          positions, kernel_fns or {}, dist=dist,
                          specs=specs, split=split, act=act)
    vp = vocab_parallel(cfg, dist)
    x = _norm_in(cfg, params, specs, "final_norm", x, dist, act, vp)
    head = emb if cfg.tie_embeddings else \
        _table(cfg, params, specs, dist, "head")
    if dist is None:
        loss = masked_mean(nll(unembed(x, head), targets), mask)
        return loss + 0.01 * aux, {"ce_loss": loss, "aux_loss": aux}
    if vp:
        nll_ = vocab_parallel_nll(unembed(x, head), targets, dist,
                                  dist.model_axis)
    else:
        nll_ = nll(unembed(x, head), targets)
    loss = _dist_cross_entropy(nll_, mask, dist, split)
    total = loss + 0.01 * aux
    if not split:
        # every data rank computed the same loss on the whole batch: its
        # gradients are summed over them, so each carries 1/n of it
        total = _ScaleGrad.apply(total, 1.0 / dist.data_size)
    return total, {"ce_loss": loss, "aux_loss": aux}


def _cache_len(cfg, cache, batch, dist):
    """The global sequence length of a mesh's decode cache: its first
    attention layer's block length times the sizes of the axes its
    layout cuts the sequence over (``sharding.cache_seq_axes``)."""
    for c in cache["layers"]:
        for key in ("k", "c_kv"):
            if key in c:
                axes = shd.cache_seq_axes(cfg, batch, dist)
                return c[key].shape[1] * C.axes_size(dist, axes)
    return 1


def decode_step(cfg, params, cache, token, pos, kernel_fns=None,
                dist=None):
    """token: (B,1) int; pos: (B,) absolute position of ``token``. The
    attention caches are updated in place (see ``gqa_decode`` and
    ``mla_decode``); the recurrent states come back as new tensors.

    On a mesh (``dist``): ``token`` and ``pos`` global, ``params`` and
    ``cache`` the rank's blocks (``decode_cache_specs``; a cache whose
    sequence is cut takes a length its axes divide); the logits come
    back whole. No layer's cache is gathered: a GQA layer decodes on its
    kv heads and/or its sequence block (``gqa_decode_sp``), MLA on its
    latent rows (``mla_decode``), RWKV and Mamba on their heads' and
    channels' states."""
    dist = moe_mod.as_dist(dist, "decode_step")
    specs, split, cspecs, B = None, True, None, token.shape[0]
    if dist is not None:
        specs = _param_specs(cfg, dist)
        cspecs = shd.decode_cache_specs(
            cfg, B, _cache_len(cfg, cache, B, dist), dist)["layers"]
        split, rows = _local_rows({"token": token, "pos": pos}, dist)
        token, pos = rows["token"], rows["pos"]
    emb, final_norm, head = _top(cfg, params, specs, dist)
    x = _lookup(cfg, emb, token, dist)
    act = act_dim(cfg, dist, (B, 1, x.shape[2]))
    x, caches = _run_stack(cfg, params, _constrain_act(x, dist, act),
                           pos[:, None], kernel_fns, want_cache=False,
                           in_cache=cache["layers"], pos=pos, dist=dist,
                           specs=specs, split=split, cspecs=cspecs, act=act)
    x = _last_normed(cfg, x, final_norm, dist, act)
    logits = _last_logits(cfg, x, head, dist, split)
    return logits, {"pos_offset": pos + 1, "layers": caches}


@functools.lru_cache(maxsize=16)
def _param_specs(cfg, dist):
    return shd.param_specs(cfg, dist)[0]
