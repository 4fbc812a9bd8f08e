"""Declarative sharding rules for parameters, optimizer state, caches
and batches (counterpart of ``repro/distributed/sharding.py``), and
the cut of a whole tree into this rank's blocks and back.

A spec is a plain tuple with one entry a dimension: None, an axis name
or a tuple of names -- ``tuple(PartitionSpec(...))`` of the reference's
spec, so a test compares the two with ``==``. Shapes come from the
port's ``init_params`` on the ``meta`` device (a cache's specs from the
config alone), never from allocated tensors. Policy (the reference's):

  * TP   : d_ff, attention heads, vocab (head), rwkv/mamba inner dims
           over the 'model' axis;
  * FSDP : the complementary dim of every large matrix over 'data';
  * EP   : expert dims as ``moe.moe_param_specs`` lays them out;
  * DP   : batch over ('pod', 'data') (the pod axis extends data);
  * SP   : decode caches shard KV-seq over data when the batch does not
           divide it, and over 'model' when the kv heads do not.

The port keeps a decode cache in that layout (``decode_cache_specs``):
prefill hands back each rank's blocks, and a decode step attends over
its blocks (a partial softmax combined over the sequence's axes, a
rank's kv heads, rwkv's heads, Mamba's channels) without gathering the
cache. Mamba's ``in_proj`` columns are ``[x | z]``: its 'model' entry is
a ``collectives.Halves`` axis, so a rank's block holds the x and z
columns of its channels (``block`` cuts each half, ``unblock`` puts
them back; a whole leaf, a checkpoint's, is the reference's).

The residual stream between layers is laid out by ``act_spec`` (the
reference's ``_constrain_act``): under the default ``act_shard ==
"dmodel"`` a rank keeps its 1/m block of d, which is what remat saves.

MLA attention matrices stay model-replicated (minicpm3's 40 heads do
not divide a 16-way axis). The port's parameters are per-layer dicts
(``params["layers"][i]``, ``core/convert.py`` un-stacks the
reference's), so the reference's leading ``stack`` entry
(``sharding.py:122-123``, the scanned layer dim, always None) maps to
no dimension here: a layer leaf's spec is the reference's without it.
Where a rule reads the number of dimensions (MLA's ``P(fsdp) if ndim >=
2``), a stacked layer's leaf counts its stack dim, as the reference's
does, so the specs agree leaf for leaf.

``shard_tree`` cuts a whole tree to this rank's blocks by its specs (no
collective); ``unshard_tree`` gathers the blocks back into the whole
tree on every rank (``to_shardings``'s counterpart: the port places a
leaf by cutting it, there is no sharded array type).
"""
from __future__ import annotations

import functools

from repro_torch.core.tree import paths, unflatten
from repro_torch.distributed import collectives as C
from repro_torch.models.moe import DistContext, moe_param_specs


def _leaf_spec(cfg, dist: DistContext, names: list[str], ndim: int):
    ma = dist.model_axis
    fsdp = "data" if (cfg.fsdp and cfg.zero >= 3) else None
    name = names[-1]
    parent = names[-2] if len(names) > 1 else ""

    if name == "embed":
        if cfg.tie_embeddings:
            # the table doubles as the LM head: vocab over model so the
            # logits come out vocab-sharded; FSDP on d_model
            return (ma, fsdp)
        return (fsdp, ma)
    if name == "head":
        return (ma, fsdp)
    if parent == "moe":
        return moe_param_specs(cfg, dist)[name]
    if parent == "attn":
        if cfg.attn_type == "mla":
            return (fsdp,) if ndim >= 2 else ()
        if name == "wq":
            return (fsdp, ma)
        if name in ("wk", "wv"):
            # kv heads replicated over model (n_kv < model in general)
            return (fsdp, None)
        if name == "wo":
            return (ma, fsdp)
        return ()                              # q_norm / k_norm
    if parent == "mlp":
        if name in ("w_gate", "w_up"):
            return (fsdp, ma)
        return (ma, fsdp)                      # w_down
    if parent == "rwkv":
        if name in ("wr", "wk", "wv", "wg", "cm_wk"):
            return (fsdp, ma)
        if name in ("wo", "cm_wv"):
            return (ma, fsdp)
        if name == "cm_wr":
            return (fsdp, None)
        return ()                              # loras, maa, u, gn_w, w0
    if parent == "mamba":
        if name == "in_proj":
            return (fsdp, C.Halves(ma))
        if name == "out_proj":
            return (ma, fsdp)
        if name == "conv_w":
            return (None, ma)
        if name in ("conv_b", "D", "dt_bias"):
            return (ma,)
        if name == "x_proj":
            return (ma, None)
        if name == "dt_proj":
            return (None, ma)
        if name == "A_log":
            return (ma, None)
        return ()
    return ()                                  # norms and other vectors


def opt_extra_shard(cfg, dist: DistContext, spec, shape):
    """ZeRO-2: the optimizer moments of a leaf of ``shape`` (a shape, or
    anything with ``.shape``) are also sharded over 'data' on the first
    dim that is unsharded and divisible (the parameters stay replicated
    over data)."""
    if cfg.zero != 2:
        return spec
    shape = tuple(getattr(shape, "shape", shape))
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, n) in enumerate(zip(parts, shape)):
        if ax is None and n % dist.data_size == 0 and n > 1:
            parts[i] = "data" if dist.data_size == \
                C.axis_sizes(dist.mesh)["data"] else \
                C.spec_entry(dist.data_axes)
            return tuple(parts)
    return spec


@functools.lru_cache(maxsize=16)
def _meta_params(cfg):
    from repro_torch.models import model as model_lib
    return model_lib.init_params(cfg, 0, device="meta")


def _map_with_path(fn, tree, path=()):
    """A tree of ``fn(path, leaf)`` in ``tree``'s structure (dicts and
    lists; the results, tuples, are leaves)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(cfg, dist: DistContext):
    """(spec tree, meta-tensor tree) matching ``init_params(cfg)``."""
    from repro_torch.models.model import stack_plan
    shapes = _meta_params(cfg)
    n_prefix = stack_plan(cfg)[0]

    def rule(path, leaf):
        # a leaf of a layer the reference stacks counts its stack dim
        stacked = path[0] == "layers" and path[1] >= n_prefix
        return _leaf_spec(cfg, dist, [str(k) for k in path],
                          leaf.dim() + int(stacked))
    return _map_with_path(rule, shapes), shapes


def _data_entry(dist):
    return dist.data_axes if len(dist.data_axes) > 1 else "data"


def batch_specs(cfg, shape, dist: DistContext):
    """(specs, meta tensors) of the input batch of one shape cell."""
    from repro_torch.configs.base import input_specs
    specs = input_specs(cfg, shape)
    b_ax = _data_entry(dist) if shape.global_batch % dist.data_size == 0 \
        else None
    return ({k: (b_ax,) + (None,) * (v.dim() - 1) for k, v in
             specs.items()}, specs)


def cache_specs(cfg, shape, dist: DistContext):
    """(specs, meta tensors) of the decode cache of one shape cell:
    batch over data when divisible, else KV-seq over data (SP); rwkv and
    mamba states shard their head / inner dim over 'model'."""
    from repro_torch.models import model as model_lib
    return (_cache_specs(cfg, shape.global_batch, shape.seq_len, dist,
                         kv_ok=cfg.n_kv % dist.model_size == 0),
            model_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta"))


def decode_kv_heads(cfg, dist: DistContext) -> bool:
    """Whether ``decode_cache_specs`` keeps a rank's block of a GQA
    layer's kv heads over 'model' (they divide it, and not
    ``cfg.decode_sp``): its decode runs on the rank's heads."""
    return cfg.attn_type != "mla" and not cfg.decode_sp and \
        cfg.n_kv % dist.model_size == 0


def _seq_axes(dist, batch_ok, kv_sharded) -> list:
    """The axes a cache's sequence is cut over where its length divides
    them: the data axes when the batch does not divide them, 'model'
    when the kv heads do not."""
    axes = [] if batch_ok else list(C.as_axes(_data_entry(dist)))
    if not kv_sharded:
        axes.append(dist.model_axis)
    return axes


def cache_seq_axes(cfg, batch: int, dist: DistContext) -> list:
    """The axes ``decode_cache_specs`` cuts an attention layer's cache
    sequence over (where the length divides them)."""
    return _seq_axes(dist, batch % dist.data_size == 0,
                     decode_kv_heads(cfg, dist))


def _cache_specs(cfg, B, cache_len, dist, kv_ok):
    """The spec tree of ``init_cache(cfg, B, cache_len)`` (from the
    config alone: no tensor is made); ``kv_ok``: k/v keep their kv heads
    over 'model', else their sequence takes it."""
    from repro_torch.models import model as model_lib
    ma, m = dist.model_axis, dist.model_size
    batch_ok = B % dist.data_size == 0
    b_ax = _data_entry(dist) if batch_ok else None
    S = min(cache_len, cfg.swa_window) if cfg.swa_window else cache_len

    def seq(kv_sharded):
        axes = _seq_axes(dist, batch_ok, kv_sharded)
        return C.spec_entry(axes) if axes and \
            S % C.axes_size(dist, axes) == 0 else None

    def layer(kind):
        if kind == "attn" and cfg.attn_type == "mla":  # (B, S, r)
            return {k: (b_ax, seq(False), None) for k in ("c_kv", "k_rope")}
        if kind == "attn":                              # (B, S, Hkv, dh)
            return {k: (b_ax, seq(kv_ok), ma if kv_ok else None, None)
                    for k in ("k", "v")}
        if kind == "mamba":          # (B, d_conv - 1, d_in), (B, d_in, N)
            return {"conv": (b_ax, None, ma), "h": (b_ax, ma, None)}
        H = cfg.d_model // cfg.rwkv_head_dim            # wkv (B, H, dh, dh)
        return {"att_shift": (b_ax, None), "cm_shift": (b_ax, None),
                "wkv": (b_ax, ma if H % m == 0 else None, None, None)}

    return {"pos_offset": (b_ax,),
            "layers": [layer(kind) for kind, _ in
                       model_lib.layer_kinds(cfg)]}


def decode_cache_specs(cfg, batch: int, cache_len: int, dist: DistContext):
    """The layout the port's prefill hands back and its decode keeps a
    cache of ``batch`` x ``cache_len`` in on a mesh: ``cache_specs``'.
    Under ``cfg.decode_sp`` a GQA layer's k/v take the sequence over
    'model' whatever its kv heads (the layout the reference's
    ``gqa_decode_sp`` takes, its ``shard_map`` in_specs). None without
    a mesh.

    A decode reads a cache block's global length as its length times
    the product of the sizes of the sequence's axes: a mesh's decode
    cache takes a length those axes divide (``cache_specs`` keeps any
    other whole)."""
    if dist is None:
        return None
    return _cache_specs(cfg, batch, cache_len, dist,
                        kv_ok=decode_kv_heads(cfg, dist))


def act_spec(cfg, dist: DistContext, shape):
    """The layout of the residual stream between layers, global
    ``shape`` (B, T, d): the reference's ``_constrain_act`` condition for
    condition -- the batch over the data axes when B divides them; then
    'model' on the sequence under ``act_shard == "seq"`` when T divides
    the axis, or on d under ``"dmodel"`` (every config's default) when d
    divides it; else whole over 'model' (``"none"``, a decode's T of 1
    under ``"seq"``, a length the axis does not divide)."""
    B, T, d = shape
    b_ax = _data_entry(dist) if B % dist.data_size == 0 else None
    ma, m = dist.model_axis, dist.model_size
    if cfg.act_shard == "seq" and T % m == 0:
        return (b_ax, ma, None)
    if cfg.act_shard == "dmodel" and d % m == 0:
        return (b_ax, None, ma)
    return (b_ax, None, None)


def logits_spec(cfg, dist: DistContext, global_batch: int | None = None):
    b_ax = _data_entry(dist) if (global_batch is None or global_batch
                                 % dist.data_size == 0) else None
    v_ax = dist.model_axis if cfg.padded_vocab % dist.model_size == 0 \
        else None
    return (b_ax, v_ax)


def block(x, spec, dist: DistContext):
    """This rank's block of the whole tensor ``x`` laid out by ``spec``
    (no collective; a view, but a copy for a ``Halves`` entry)."""
    for dim, ent in enumerate(spec):
        axes = C.as_axes(ent)
        if not axes:
            continue
        n = C.axes_size(dist, axes) * (2 if isinstance(ent, C.Halves)
                                       else 1)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"divide over {n} ranks of {axes}")
        x = C.block_of(dist, ent, x, dim)
    return x


def unblock(x, spec, dist: DistContext):
    """The whole tensor from every rank's block ``x`` (all-gathers)."""
    for dim, ent in enumerate(spec):
        if C.as_axes(ent):
            x = C.all_gather_(dist, ent, x, dim)
    return x.contiguous()


def shard_tree(tree, specs, dist: DistContext, clone=True):
    """``tree`` cut to this rank's blocks by ``specs`` (a spec tree of
    the same structure, the specs as leaves). ``clone`` copies each
    block out of the whole tensor so the whole can be freed."""
    def cut(x, s):
        x = block(x, s, dist)
        return x.clone() if clone else x
    return spec_tree_map(cut, tree, specs)


def unshard_tree(tree, specs, dist: DistContext):
    """The whole tree from every rank's blocks (collective: every rank
    calls it, in the same order)."""
    return spec_tree_map(lambda x, s: unblock(x, s, dist), tree, specs)


def spec_leaves(specs) -> list:
    """The specs of a spec tree in leaf order (a spec is a tuple, so
    the walk stops at tuples)."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            out.append(t)
    walk(specs)
    return out


def spec_tree_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    return unflatten(tree, [fn(x, s) for (_, x), s in
                            zip(paths(tree), spec_leaves(specs))])
